"""The wave's GI rows on the textured box (the kernel's textured variant
and its plain version) against interpret-mode
rtf_tpu.render.fused_seg.fused_wave_seg, whose _seg_shade_kernel writes
them as its 15 gi_out rows: first-hit surface and every query row from
bounce 0.  One 1024-lane block (32x24 = 768 lanes): interpret mode drops
the shade kernel's block term from its seed (ROADMAP, the one-block
rule).  Tolerances as in test_torch_gi_rows.py, with the seg path's atol
5e-4."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import textured_desc  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_rows import _cfg, assert_rows_close, run_rows  # noqa: E402


def test_rows_match_fused_wave_seg():
    ref, port = run_rows(textured_desc(port=False),
                         _cfg(env_on_reflect_miss=True), 3, seg=True,
                         surf_out=True, gi_from=0)
    assert len(port[4]) == 2
    assert_rows_close(ref, port, np.ones(32 * 24, bool), 0, atol=5e-4)
    # the file textures reach the rows: kd varies across the walls' lanes
    assert port[3][6:9, port[1]].std() > 0.05
