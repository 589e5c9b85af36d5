"""The port's photon grid (rtf_tpu_torch/gi/grid.py) and photon files
(gi/io.py) against rtf_tpu/gi/grid.py and rtf_tpu/gi/io.py on the CPU,
both given one numpy photon map (`photon_map_from_arrays`):

* build_photon_grid and cap_occupancy: every array equal, the measured
  occupancies equal;
* estimate_irradiance, exact and exact=False, filters 0-2, with and
  without query normals, k below and above the photons in range: the
  irradiance within rtol 1e-5 (atol 1e-6) of rtf_tpu's, the unit mean
  direction within atol 1e-5 (its sums run in another order, and a
  direction whose components nearly cancel has no relative accuracy);
* the exact kNN estimate against a brute-force bounded-heap oracle, as
  tests/test_photon.py:96-197 checks rtf_tpu's (a density gradient, a
  cell far denser than rtf_tpu's old 128 cap, normal-free queries and
  the linear filter), rtol 2e-3 as there;
* nearest_photon against a brute-force argmin, and on an empty map;
* the .dat photon files each package writes read back by the other."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401


def photon_arrays(seed=3, n_cluster=2000, n_bg=1000, spread=4.0, pad=200):
    """pos, dir, power [n + pad, 3] float32 and count n: a clustered and a
    uniform population, the pad rows zero."""
    rng = np.random.RandomState(seed)
    pos = np.concatenate([rng.normal(0, 0.35, (n_cluster, 3)),
                          rng.uniform(-spread, spread, (n_bg, 3)),
                          np.zeros((pad, 3))]).astype(np.float32)
    cap = len(pos)
    dirs = rng.normal(size=(cap, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    power = rng.uniform(0.1, 1.0, (cap, 3)).astype(np.float32)
    return pos, dirs, power, n_cluster + n_bg


def both_grids(arrays, cell, lo, hi):
    import jax.numpy as jnp
    from rtf_tpu.gi.grid import build_photon_grid as jbuild
    from rtf_tpu.gi.photon import PhotonMapData
    from rtf_tpu_torch.gi.grid import build_photon_grid
    from rtf_tpu_torch.gi.photon import photon_map_from_arrays
    pos, dirs, power, n = arrays
    jpm = PhotonMapData(jnp.asarray(pos), jnp.asarray(dirs),
                        jnp.asarray(power), jnp.int32(n))
    return (jbuild(jpm, cell, lo, hi),
            build_photon_grid(photon_map_from_arrays(pos, dirs, power, n,
                                                     device="cpu"),
                              cell, lo, hi))


GRID_KEYS = ("pos", "dir", "power", "cell_start", "cell_count", "origin",
             "n_valid")


def _grids_equal(jg, pg):
    for k in GRID_KEYS:
        a, b = np.asarray(getattr(jg, k)), getattr(pg, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (jg.dims, jg.cell_size, jg.max_occupancy) \
        == (pg.dims, pg.cell_size, pg.max_occupancy)


def test_grid_and_cap_match_jax():
    from rtf_tpu.gi.grid import cap_occupancy as jcap
    from rtf_tpu_torch.gi.grid import cap_occupancy
    jg, pg = both_grids(photon_arrays(), 1.0, (-4, -4, -4), (4, 4, 4))
    _grids_equal(jg, pg)
    assert pg.max_occupancy > 200
    for cap in (64, 200, 10 ** 6):
        _grids_equal(jcap(jg, cap), cap_occupancy(pg, cap))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("filter_type", [0, 1, 2])
def test_estimate_irradiance_matches_jax(exact, filter_type):
    import jax.numpy as jnp
    from rtf_tpu.gi.grid import estimate_irradiance as jest
    from rtf_tpu_torch.gi.grid import estimate_irradiance
    jg, pg = both_grids(photon_arrays(), 1.0, (-4, -4, -4), (4, 4, 4))
    rng = np.random.RandomState(7)
    q = rng.uniform(-3.5, 3.5, (300, 3)).astype(np.float32)
    q[:100] = rng.normal(0, 0.4, (100, 3))           # in the cluster
    nrm = rng.normal(size=(300, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    for qn in (None, nrm):
        for k in (16, 400):
            want = jest(jg, jnp.asarray(q),
                        None if qn is None else jnp.asarray(qn), 1.0, k,
                        filter_type, exact=exact)
            got = estimate_irradiance(
                pg, torch.as_tensor(q),
                None if qn is None else torch.as_tensor(qn), 1.0, k,
                filter_type, exact=exact)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       atol=1e-5)
            assert (got[0].numpy() > 0).any()


def _knn_oracle(pos, dirs, pw, q, radius, k, nrm=None):
    """tests/test_photon.py::_np_knn_oracle: the k nearest accepted
    photons; the area radius is the k-th nearest distance when more than
    k are in range, else the cap radius."""
    d2 = ((pos - q) ** 2).sum(1)
    ok = d2 < radius * radius
    if nrm is not None:
        ok &= dirs @ nrm < 0
    d2s = np.sort(d2[ok])
    if len(d2s) > k:
        r2 = d2s[k - 1]
        sel = ok & (d2 <= r2)
    else:
        r2 = radius * radius
        sel = ok
    return pw[sel].sum(0) / (np.pi * r2)


@pytest.mark.parametrize("case", ["gradient", "dense_cell"])
def test_exact_knn_matches_bruteforce(case):
    from rtf_tpu_torch.gi.grid import build_photon_grid, estimate_irradiance
    from rtf_tpu_torch.gi.photon import photon_map_from_arrays
    rng = np.random.RandomState(11 if case == "gradient" else 3)
    if case == "gradient":     # a caustic-like cluster in a background
        pos = np.concatenate([rng.normal(0, 0.35, (3000, 3)),
                              rng.uniform(-8, 8, (800, 3))])
        radius, ks, lim = 2.0, (64,), 8
        q = np.array([[0, 0, 0], [0.3, 0, 0], [0.8, 0.4, 0.2],
                      [2.5, 0, 0], [6, 6, 6]])
    else:                      # ~700 photons in one cell
        pos = np.concatenate([rng.uniform(0.05, 0.95, (700, 3)),
                              rng.uniform(-4, 4, (300, 3))])
        radius, ks, lim = 1.0, (16, 400, 10 ** 9), 4
        q = np.array([[0.5, 0.5, 0.5], [0.9, 0.1, 0.5], [3.0, 3.0, 3.0]])
    pos, q = pos.astype(np.float32), q.astype(np.float32)
    n = len(pos)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pw = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    grid = build_photon_grid(photon_map_from_arrays(pos, dirs, pw, n,
                                                    device="cpu"),
                             radius, (-lim,) * 3, (lim,) * 3)
    if case == "dense_cell":
        assert grid.max_occupancy > 128
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (len(q), 1))
    for k in ks:
        irr, _ = estimate_irradiance(grid, torch.as_tensor(q),
                                     torch.as_tensor(nrm), radius, k)
        for qi in range(len(q)):
            want = _knn_oracle(pos, dirs, pw, q[qi], radius, k, nrm[qi])
            np.testing.assert_allclose(irr[qi].numpy(), want, rtol=2e-3,
                                       atol=1e-5, err_msg=f"k={k} q={qi}")


def test_exact_knn_normal_free_and_linear_filter():
    from rtf_tpu_torch.gi.grid import build_photon_grid, estimate_irradiance
    from rtf_tpu_torch.gi.photon import photon_map_from_arrays
    rng = np.random.RandomState(5)
    pos = rng.normal(0, 0.5, (2000, 3)).astype(np.float32)
    dirs = rng.normal(size=(2000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pw = np.ones((2000, 3), np.float32) * 0.01
    radius, k = 2.0, 32
    grid = build_photon_grid(photon_map_from_arrays(pos, dirs, pw, 2000,
                                                    device="cpu"),
                             radius, (-4, -4, -4), (4, 4, 4))
    q = np.array([[0, 0, 0], [1, 1, 0]], np.float32)
    for filt in (0, 1):
        irr, _ = estimate_irradiance(grid, torch.as_tensor(q), None,
                                     radius, k, filt)
        for qi in range(len(q)):
            d2 = ((pos - q[qi]) ** 2).sum(1)
            d2s = np.sort(d2[d2 < radius * radius])
            r2 = d2s[k - 1] if len(d2s) > k else radius * radius
            sel = d2 <= r2
            w = 1.0 - np.sqrt(d2[sel]) / np.sqrt(r2) if filt else 1.0
            area = np.pi / 3.0 * r2 if filt else np.pi * r2
            want = (pw[sel] * np.reshape(w, (-1, 1))).sum(0) / area
            np.testing.assert_allclose(irr[qi].numpy(), want, rtol=2e-3)


def test_nearest_photon_matches_bruteforce():
    from rtf_tpu_torch.gi.grid import nearest_photon
    arrays = photon_arrays(seed=9, pad=0)
    jg, pg = both_grids(arrays, 1.0, (-4, -4, -4), (4, 4, 4))
    rng = np.random.RandomState(2)
    q = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    gp, gd, gw, gd2 = (x.numpy() for x in nearest_photon(
        pg, torch.as_tensor(q), photon_chunk=512))
    pos = pg.pos.numpy()
    d2 = ((q[:, None, :] - pos[None]) ** 2).sum(-1)
    best = d2.argmin(1)
    np.testing.assert_allclose(gd2, d2[np.arange(64), best], rtol=1e-5)
    np.testing.assert_array_equal(gp, pos[best])
    np.testing.assert_array_equal(gw, pg.power.numpy()[best])


def test_nearest_photon_empty_map():
    from rtf_tpu_torch.gi.grid import nearest_photon
    _, pg = both_grids((np.zeros((16, 3), np.float32),) * 3 + (0,), 1.0,
                       (-1, -1, -1), (1, 1, 1))
    gp, gd, gw, gd2 = nearest_photon(pg, torch.zeros((4, 3)))
    assert torch.isinf(gd2).all()
    assert (gp == 0).all() and (gw == 0).all() and (gd == 0).all()


def test_photon_dat_files_cross_read(tmp_path):
    from rtf_tpu.gi.io import load_photon_dat as jload
    from rtf_tpu.gi.io import save_photon_dat as jsave
    from rtf_tpu_torch.gi.io import load_photon_dat, save_photon_dat
    pos, dirs, power, n = photon_arrays(seed=4, pad=50)
    jsave(str(tmp_path / "j.dat"), pos, dirs, power, n)
    save_photon_dat(str(tmp_path / "p.dat"), torch.as_tensor(pos),
                    torch.as_tensor(dirs), torch.as_tensor(power), n)
    assert (tmp_path / "j.dat").read_bytes() \
        == (tmp_path / "p.dat").read_bytes()
    for a, b in zip(load_photon_dat(str(tmp_path / "j.dat")),
                    jload(str(tmp_path / "p.dat"))):
        np.testing.assert_array_equal(a, b)
    got = load_photon_dat(str(tmp_path / "j.dat"))
    assert got[0].shape == (n, 3)
    np.testing.assert_array_equal(got[0], pos[:n])
    # 16-bit x and y, z rebuilt from them with its sign bit
    np.testing.assert_allclose(got[1][:, :2], dirs[:n, :2], atol=1e-4)
    clear = np.abs(dirs[:n, 2]) > 1e-3
    np.testing.assert_array_equal((got[1][:, 2] > 0)[clear],
                                  (dirs[:n, 2] > 0)[clear])


def test_estimate_does_not_depend_on_the_chunks(monkeypatch):
    """Small query blocks and candidate chunks (a query alone over the
    budget too) give the same estimate bit for bit."""
    from rtf_tpu_torch.gi import grid as G
    _, pg = both_grids(photon_arrays(), 1.0, (-4, -4, -4), (4, 4, 4))
    rng = np.random.RandomState(1)
    q = torch.as_tensor(rng.uniform(-3, 3, (200, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(200, 3)).astype(np.float32)), dim=1)
    want = G.estimate_irradiance(pg, q, nrm, 1.0, 16)
    monkeypatch.setattr(G, "QUERIES_PER_BLOCK", 37)
    monkeypatch.setattr(G, "CANDIDATES_PER_CHUNK", 300)
    got = G.estimate_irradiance(pg, q, nrm, 1.0, 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
