"""The port's textured wave on the MXU tables (the kernel's textured MXU
variant's plain version) against interpret-mode
rtf_tpu.render.fused_seg.fused_wave_seg with mxu_tables: its
_seg_hit_kernel with has_mesh_tables (the mesh uv from the shade rows)
and its _seg_shade_kernel's MXU shadow any-hit.  Bounce 0: hit masks
equal, radiance within atol 5e-4 (test_fused_seg.py:70), z within rtol
1e-4.  Past bounce 0 under the one-block rule (the wave fits in one
1024-lane block, ROADMAP Queue 3): at most 1% of lanes outside 5e-4 and
the mean within 1%."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import textured_desc  # noqa: E402
from test_torch_mxu_bounces import assert_bounces  # noqa: E402
from test_torch_mxu_wave import _cfg, assert_bounce0, run_mxu  # noqa: E402


def test_mxu_seg_bounce0():
    ref, port, _ = run_mxu(textured_desc(port=False, mesh_subdiv=3), _cfg(),
                           3, seg=True)
    assert_bounce0(ref, port, atol=5e-4)


def test_mxu_seg_bounces2_env_map():
    from rtf_tpu_torch.render import wave as W
    cfg = _cfg(bounces=2, split_mode="rr", env_on_reflect_miss=True)
    ref, port, _ = run_mxu(textured_desc(port=False, mesh_subdiv=3), cfg,
                           2 ** 31 - 5, seg=True)
    assert ref[0].shape[1] <= W.BLOCK
    assert_bounces(ref, port, atol=5e-4)
