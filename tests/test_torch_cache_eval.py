"""The irradiance cache's wavefront evaluator (rtf_tpu_torch/gi/
irradiance_cache.py::_eval_irradiance) against rtf_tpu's, on the CPU, per
point, with jax.random's draws fed through the port's draw seam
(`CacheDraws`): per hemisphere sample i, split(fold_in(key, i)) gives the
azimuth and sin^2 theta uniforms and fold_in(fold_in(fold_in(key, i), 3),
31) the first Russian-roulette choice.  The points are rtf_tpu's own
pixel-centre first hits on test_irradiance_cache.py's box without the mesh
(32x24, hard shadows, no glossy material), carried across with the scene.
At bounces=1 (no bounce past the hemisphere ray) every point agrees within
atol 2e-4; at bounces=2 the roulette's rounding can flip a choice, so at
most 1% of points lie outside it and the mean agrees within 1%.  A whole
build at bounces=1 with the draws fed level by level traces the same
points and agrees within atol 2e-4 at every pixel."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402


class FedDraws:
    """rtf_tpu's draws of one evaluator call with key `key`, through the
    port's CacheDraws interface; the generator takes no draw here."""

    def __init__(self, key, n):
        self.key, self.n = key, n
        self.gen = torch.Generator().manual_seed(0)

    def _u(self, k):
        return torch.as_tensor(np.array(jax.random.uniform(k, (self.n,))))

    def hemisphere(self, level, s, n, device):
        out = []
        for i in range(s):
            k1, k2 = jax.random.split(jax.random.fold_in(self.key, i))
            out.append(torch.stack([self._u(k1), self._u(k2)]))
        return torch.stack(out)[:, :, :n]

    def rr(self, level, i, n, device):
        kc = jax.random.fold_in(jax.random.fold_in(self.key, i), 3)
        return self._u(jax.random.fold_in(kc, 31))[:n]

    def wave_seed(self, level):
        return int(jax.random.randint(jax.random.fold_in(self.key, 5), (), 0,
                                      2 ** 31 - 1))


class FedBuildDraws:
    """rtf_tpu's draws of a whole build with key `key` (kf, ke = split(key);
    level li's evaluator key fold_in(ke, li)), each level's drawn at
    rtf_tpu's batch size for it: the level's grid at level 0, its budget
    after, whose first n lanes are the port's n traced points."""

    def __init__(self, key, w, h, max_spacing, budget_frac=0.35):
        from rtf_tpu_torch.gi.irradiance_cache import _grid_points
        self.ke = jax.random.split(key)[1]
        self.gen = torch.Generator().manual_seed(0)
        self.sizes, s = [], max_spacing
        while s >= 1:
            m = len(_grid_points(w, h, s)[0])
            self.sizes.append(m if not self.sizes
                              else min(max(int(m * budget_frac), 256), m))
            s //= 2

    def _level(self, level):
        return FedDraws(jax.random.fold_in(self.ke, level),
                        self.sizes[level])

    def hemisphere(self, level, s, n, device):
        return self._level(level).hemisphere(level, s, n, device)

    def rr(self, level, i, n, device):
        return self._level(level).rr(level, i, n, device)

    def wave_seed(self, level):
        return self._level(level).wave_seed(level)


def first_hits(js):
    """rtf_tpu's pixel-centre first hits: (p, n, mask) as numpy."""
    from rtf_tpu.gi.irradiance_cache import _first_hits
    p, n, _, _, hit, front = _first_hits(js, jax.random.PRNGKey(0))
    return np.array(p), np.array(n), np.array(hit) & np.array(front)


@pytest.fixture(scope="module")
def scenes():
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    js = build_scene(box_scene(32, 24, with_mesh=False))
    return js, port_scene_from_jax(js)


@pytest.mark.parametrize("bounces", [1, 2])
def test_wavefront_evaluator_matches(scenes, bounces):
    import jax.numpy as jnp
    from rtf_tpu.gi.irradiance_cache import _eval_irradiance as jeval
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.gi.irradiance_cache import _eval_irradiance
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import scene_tables
    js, ps = scenes
    gi = dict(min_samples=2, max_samples=2, bounces=bounces, shadow_min=1,
              shadow_max=1, gi_mode="hemisphere", hemisphere_samples=3,
              split_mode="rr")
    p, n, mask = first_hits(js)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jeval(js, JConfig(**gi), jnp.asarray(p), jnp.asarray(n),
                           jnp.asarray(mask), key))
    got = _eval_irradiance(ps, RenderConfig(**gi), scene_tables(ps),
                           torch.as_tensor(p), torch.as_tensor(n),
                           torch.as_tensor(mask), FedDraws(key, len(p)), 0)
    got = got.numpy()
    assert np.isfinite(got).all() and ref.mean() > 0.01
    assert (got[~mask] == 0).all()
    if bounces == 1:
        np.testing.assert_allclose(got, ref, atol=2e-4)
    else:
        off = (np.abs(got - ref) > 2e-4).any(-1)
        assert off.mean() <= 0.01, off.mean()
        assert abs(got.mean() / ref.mean() - 1.0) <= 0.01


def test_build_with_fed_draws_matches(scenes):
    """The whole build on the wavefront evaluator (bounces=1), rtf_tpu's
    draws fed in level by level: the same points traced, E within atol
    2e-4 at every pixel."""
    from rtf_tpu.gi.irradiance_cache import build_irradiance_cache as jbuild
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.gi.irradiance_cache import build_irradiance_cache
    from rtf_tpu_torch.render.config import RenderConfig
    js, ps = scenes
    gi = dict(min_samples=2, max_samples=2, bounces=1, shadow_min=1,
              shadow_max=1, gi_mode="hemisphere", hemisphere_samples=3,
              split_mode="rr")
    key = jax.random.PRNGKey(4)
    ref = jbuild(js, JConfig(**gi), key, max_spacing=8)
    got = build_irradiance_cache(
        ps, RenderConfig(**gi), draws=FedBuildDraws(key, 32, 24, 8),
        max_spacing=8, evaluator="wavefront", device="cpu")
    np.testing.assert_array_equal(got.computed.numpy(),
                                  np.asarray(ref.computed))
    np.testing.assert_allclose(got.E.numpy(), np.asarray(ref.E), atol=2e-4)
    assert 0.0 < float(got.computed.float().mean()) < 1.0
    assert float(got.E.max()) > 0.01
