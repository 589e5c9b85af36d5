"""The irradiance cache's fused evaluator (rtf_tpu_torch/gi/
irradiance_cache.py::_eval_irradiance_fused: render/gi.py::gi_chunks from a
synthetic surface, the wave on its plain version on the CPU) against
rtf_tpu's, whose fused_gi_chunks runs the Pallas wave kernel in interpret
mode, on one batch: rtf_tpu's pixel-centre first hits of the 32x24 box
(the 80-face ball) with 2 hemisphere samples, jax.random's draws and wave
seed fed in (tests/test_torch_cache_eval.py::FedDraws).  The GI rows' rules:
with bounces=1 the child waves stop at bounce 0 and every point agrees
within atol 2e-4; with bounces=3 a rounding difference can flip a
Russian-roulette choice, so at most 1% of points lie outside it and the
mean agrees within 1%.  The bounces=3 case is
tests/test_torch_cache_fused_bounces.py (one interpret-mode call a file,
about 35 s each on a CPU)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_cache_eval import FedDraws, first_hits  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402


def check_fused_evaluator(bounces):
    import jax.numpy as jnp
    from rtf_tpu.gi.irradiance_cache import _eval_irradiance_fused as jeval
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.gi.irradiance_cache import _eval_irradiance_fused
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import scene_tables
    js = build_scene(box_scene(32, 24, mesh_subdiv=1))
    ps = port_scene_from_jax(js)
    gi = dict(min_samples=2, max_samples=2, bounces=bounces, shadow_min=1,
              shadow_max=1, gi_mode="hemisphere", hemisphere_samples=2,
              split_mode="rr")
    p, n, mask = first_hits(js)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jeval(js, JConfig(**gi), jnp.asarray(p), jnp.asarray(n),
                           jnp.asarray(mask), key))
    got = _eval_irradiance_fused(
        ps, RenderConfig(**gi), scene_tables(ps), torch.as_tensor(p),
        torch.as_tensor(n), torch.as_tensor(mask), FedDraws(key, len(p)),
        0).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert ref.mean() > 0.01 and (got[~mask] == 0).all()
    if bounces == 1:
        np.testing.assert_allclose(got, ref, atol=2e-4)
    else:
        off = (np.abs(got - ref) > 2e-4).any(-1)
        assert off.mean() <= 0.01, off.mean()
        assert abs(got.mean() / ref.mean() - 1.0) <= 0.01


def test_fused_evaluator_matches():
    check_fused_evaluator(1)
