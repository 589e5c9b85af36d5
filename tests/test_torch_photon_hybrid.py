"""The photon pipeline's hybrid frame in the mean only (its draws differ), on
test_torch_photon_render.py's carried photon and caustic grids, within
test_torch_gi_render.py's 8% band: the port's fused frame (photon GI with
photon and caustic volumes baked from the grids, once each and kept on
them) against rtf_tpu's frame on the CPU (its XLA wavefront, with its
photon volume and the exact caustic gather)."""
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_photon_render import HEMI, _renders, maps  # noqa: E402,F401


def test_hybrid_matches_jax_mean(maps):
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import render_path
    kw = dict(HEMI, gi_mode="photon", split_mode="rr", photon_volume=True)
    assert render_path(maps[1], RenderConfig(**kw), maps[3][1])[0] \
        == "fused"
    got, want = _renders(maps, **kw)
    assert all(len(g.volumes) == 1 for g in maps[3])
    mean_p, mean_r = got.radiance.mean(), want.radiance.mean()
    assert abs(mean_p - mean_r) / mean_r < 0.08, (mean_p, mean_r)
