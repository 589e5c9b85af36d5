"""The irradiance cache's grid and level logic (rtf_tpu_torch/gi/
irradiance_cache.py) against rtf_tpu's, on the CPU, without an
interpret-mode kernel: `_grid_points` and `_bilerp_from_level` on seeded
inputs (equal index sets, values within 1e-6), and `build_irradiance_cache`
with one deterministic evaluator, a function of the point and its normal
only, put in place of `_eval_irradiance` in both packages (pytest's
monkeypatch; rtf_tpu's file is not edited).  The scene is
test_irradiance_cache.py's box without the mesh at 32x24, carried across
so both trace the same tables.  `computed` must be equal and E within
1e-6 (a gate may flip only on a point whose gating value lies within 1e-5
of its threshold; none does here, so the check is equality).
budget_frac=0.01 makes a level's gated points overflow its budget (256
points)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402

W, H = 32, 24


@pytest.mark.parametrize("w,h,s", [(32, 24, 16), (32, 24, 1), (800, 600, 16),
                                   (800, 600, 2), (33, 17, 4)])
def test_grid_points_match(w, h, s):
    from rtf_tpu.gi import irradiance_cache as J
    from rtf_tpu_torch.gi import irradiance_cache as P
    for a, b in zip(P._grid_points(w, h, s), J._grid_points(w, h, s)):
        np.testing.assert_array_equal(a, b)


def test_bilerp_from_level_matches():
    import jax.numpy as jnp
    from rtf_tpu.gi import irradiance_cache as J
    from rtf_tpu_torch.gi import irradiance_cache as P
    rng = np.random.RandomState(3)
    w, h = 40, 30
    E = rng.uniform(0.0, 1.0, (w * h, 3)).astype(np.float32)
    z = rng.uniform(5.0, 80.0, w * h).astype(np.float32)
    z[rng.rand(w * h) < 0.1] = 1e30                       # misses
    n = rng.normal(size=(w * h, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    _, xs, ys = P._grid_points(w, h, 8)
    ids, _, _ = P._grid_points(w, h, 4)
    ref = J._bilerp_from_level(jnp.asarray(E), jnp.asarray(z), jnp.asarray(n),
                               w, h, xs, ys, jnp.asarray(ids % w),
                               jnp.asarray(ids // w))
    qx = torch.as_tensor(ids % w)
    qy = torch.as_tensor(ids // w)
    got = P._bilerp_from_level(torch.as_tensor(E), torch.as_tensor(z),
                               torch.as_tensor(n), w, h, xs, ys, qx, qy)
    assert got[0].dtype == torch.float32
    for name, a, b in zip(("E", "spread", "z_spread", "n_dot"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def _field(p, n, xp):
    """The deterministic evaluator's E [B,3]: smooth in p, tilted by n."""
    base = 0.5 + 0.45 * xp.sin(0.45 * p[:, 0] + 0.3 * p[:, 2])
    tilt = 0.6 + 0.4 * xp.abs(n[:, 2])
    return xp.stack([base * tilt, base * 0.5 + 0.1 * n[:, 0] ** 2,
                     tilt * 0.3], 1)


@pytest.fixture(scope="module")
def scenes():
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    js = build_scene(box_scene(W, H, with_mesh=False))
    return js, port_scene_from_jax(js)


@pytest.mark.parametrize("budget_frac", [0.35, 0.01])
def test_levels_match(scenes, monkeypatch, budget_frac):
    import jax.numpy as jnp
    from rtf_tpu.gi import irradiance_cache as J
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.gi import irradiance_cache as P
    from rtf_tpu_torch.render.config import RenderConfig
    js, ps = scenes
    gi = dict(min_samples=2, max_samples=2, bounces=1, shadow_min=1,
              shadow_max=1, gi_mode="hemisphere", hemisphere_samples=8,
              split_mode="rr")
    calls = {"jax": [], "port": []}

    def jeval(scene, cfg, p, n, mask, key):
        calls["jax"].append(int(jnp.sum(mask)))
        return _field(p, n, jnp)

    def peval(scene, cfg, tables, p, n, mask, draws, level):
        calls["port"].append(int(mask.sum()))
        return _field(p, n, torch)
    monkeypatch.setattr(J, "_eval_irradiance", jeval)
    monkeypatch.setattr(P, "_eval_irradiance", peval)
    kw = dict(max_spacing=8, budget_frac=budget_frac)
    ref = J.build_irradiance_cache(js, JConfig(**gi), jax.random.PRNGKey(0),
                                   **kw)
    got = P.build_irradiance_cache(ps, RenderConfig(**gi), 0,
                                   evaluator="wavefront", device="cpu", **kw)
    # the same points evaluated at each level (level 0: every grid point,
    # masked; later levels the gated points up to the budget, where the
    # port makes no call for none)
    assert calls["port"] == [c for c in calls["jax"] if c] \
        and len(calls["port"]) > 2
    budgets = [min(max(int(len(P._grid_points(W, H, s)[0]) * budget_frac),
                       256), len(P._grid_points(W, H, s)[0]))
               for s in (4, 2, 1)]
    if budget_frac < 0.1:
        # the budget overflows: the first `budget` gated points in grid
        # order are traced, the rest keep their interpolated values
        assert budgets[-1] in calls["port"][1:]
    for name in ("hit", "front", "z", "n", "kd"):
        np.testing.assert_allclose(getattr(got, name).numpy().astype(float),
                                   np.asarray(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.computed.numpy(),
                                  np.asarray(ref.computed))
    np.testing.assert_allclose(got.E.numpy(), np.asarray(ref.E), atol=1e-6)
    frac = float(got.computed.float().mean())
    assert 0.0 < frac < 1.0
