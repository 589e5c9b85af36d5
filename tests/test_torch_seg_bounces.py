"""The port's wave on the textured box past bounce 0 against interpret-mode
rtf_tpu.render.fused_seg.fused_wave_seg, per lane.

Interpret mode drops the block term of _seg_shade_kernel's RNG seed
(fused_seg.py:224, 445), so the reference draws the compiled kernel's
numbers (and the port's) only while the wave fits in one 1024-lane
block: the test runs at 32x24 (768 lanes).  A rounding difference can
flip a Russian-roulette choice, so at most 1% of lanes may lie outside
atol 5e-4 and the mean radiance agrees within 1%."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_torch_common import textured_desc  # noqa: E402
from test_torch_seg_wave import _cfg, run_seg_both  # noqa: E402

FLIP_SHARE = 0.01
SEED = 2 ** 31 - 5


def test_seg_wave_bounces2_env_map():
    """Mirror and glass children that leave the box through its open front
    sample the environment map (env_on_reflect_miss)."""
    from rtf_tpu_torch.render import wave as W
    cfg = _cfg(bounces=2, split_mode="rr", env_on_reflect_miss=True)
    (rr, rh, rz), (pr, ph, pz), inputs = run_seg_both(
        textured_desc(port=False), cfg, SEED)
    assert rr.shape[0] <= W.BLOCK
    np.testing.assert_array_equal(ph, rh)
    off = (np.abs(pr - rr) > 5e-4).any(-1).mean()
    assert off <= FLIP_SHARE, off
    mean_r, mean_p = rr.mean(), pr.mean()
    assert mean_r > 0.05
    assert abs(mean_p - mean_r) / mean_r < 0.01
    # reflection misses sampled the map: without the environment on them
    # the port's radiance changes
    no_env = W.wave_plain(cfg.with_(env_on_reflect_miss=False), *inputs,
                          SEED)[0].T.numpy()
    assert (np.abs(no_env - pr) > 1e-3).any()
