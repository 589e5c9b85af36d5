"""The port's irradiance-volume bake (rtf_tpu_torch/gi/volume.py::
build_irradiance_volume) against rtf_tpu/gi/volume.py's on one grid built
by each package from the same numpy photon map (a dense cluster in a
uniform background): with the occupancy cap triggered (the cluster's cells
thinned to max(occ_cap, 2k) photons), without it, at the three filters
and two k.  dims, origin and cell must be equal, the table [6, corners]
within rtol 1e-5 (atol 1e-6 on the irradiance rows; the unit mean
direction rows within atol 1e-5: their sums run in another order), and
the volume at its corners equal to the port's own exact estimate there."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_photon_grid import both_grids, photon_arrays  # noqa: E402


@pytest.mark.parametrize("occ_cap,filter_type,k", [
    (64, 0, 16), (64, 1, 16), (64, 2, 100), (None, 0, 400)])
def test_volume_matches_jax(occ_cap, filter_type, k):
    from rtf_tpu.gi.volume import build_irradiance_volume as jbake
    from rtf_tpu_torch.gi.grid import estimate_irradiance
    from rtf_tpu_torch.gi.volume import build_irradiance_volume
    lo, hi = (-4.0, -4.0, -3.0), (4.0, 3.5, 4.0)
    jg, pg = both_grids(photon_arrays(seed=6, n_cluster=3000), 1.0, lo, hi)
    if occ_cap is not None:
        assert pg.max_occupancy > max(occ_cap, 2 * k)   # the cap fires
    want = jbake(jg, 1.0, k, lo, hi, filter_type=filter_type,
                 occ_cap=occ_cap)
    got = build_irradiance_volume(pg, 1.0, k, lo, hi,
                                  filter_type=filter_type, occ_cap=occ_cap)
    assert got.dims == want.dims == (8, 8, 7)
    assert got.cell == want.cell
    np.testing.assert_array_equal(got.origin.numpy(),
                                  np.asarray(want.origin))
    table, ref = got.table.numpy(), np.asarray(want.table)
    assert table.shape == ref.shape == (6, 9 * 9 * 8)
    np.testing.assert_allclose(table[:3], ref[:3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(table[3:], ref[3:], atol=1e-5)
    assert (table[:3] > 0).mean() > 0.5
    if occ_cap is None and filter_type == 0:
        # the corners' exact normal-free estimate, from the grid directly
        nx, ny, nz = (d + 1 for d in got.dims)
        ii = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                  np.arange(nz), indexing="ij"), -1)
        corners = (ii.reshape(-1, 3).astype(np.float32) * got.cell
                   + np.asarray(lo, np.float32))
        irr, _ = estimate_irradiance(pg, torch.as_tensor(corners), None,
                                     1.0, k)
        np.testing.assert_allclose(table[:3].T, irr.numpy(), rtol=1e-5,
                                   atol=1e-6)
