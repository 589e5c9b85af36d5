"""The port's photon shooter (rtf_tpu_torch/gi/photon.py) against
rtf_tpu/gi/photon.py on the CPU.

* `_rr_bounce` lane by lane on 4096 random surfaces and materials with the
  uniforms jax.random draws from one key: alive and specular flags equal
  on every lane but those whose RR variate u * total lies within 1e-6
  (relative) of a choice threshold (counted, at most 0.1% of lanes); on
  the others the new direction and the power factor within rtol/atol
  1e-5.
* `shoot_photons` with the reference's draws fed in (`JaxDraws`: per chunk
  fold_in, split(3), randint and the cube uniform; per bounce fold_in and
  split(3)) on the 32x24 box without its mesh and with it (mesh_subdiv=1,
  rtf_tpu with mesh_algo="pallas_interpret"), the global map, the caustic
  map, and a global map past its capacity: the stored counts within 0.5%,
  and the maps, each sorted by position rounded to 1e-2, agree within
  atol 1e-3 (positions, directions: a caustic photon crosses up to five
  specular surfaces, and its position on the 64-unit box drifts by up to
  about 7e-4 from rtf_tpu's rounding) and rtol 1e-4 (powers) on at least
  99% of the rows.
* the port's own shooter (a torch.Generator) gives the same map twice for
  one seed and another map for another seed.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)


class JaxDraws:
    """rtf_tpu's draws of `_shoot_photons_batch` and `_rr_bounce` from one
    key, for the port's shooter."""

    def __init__(self, key):
        self.key = key

    def _keys(self, chunk):
        return jax.random.split(jax.random.fold_in(self.key, chunk), 3)

    def emission(self, chunk, n, n_lights, device):
        k_pick, k_dir, _ = self._keys(chunk)
        pick = np.array(jax.random.randint(k_pick, (n,), 0, n_lights))
        cube = np.array(jax.random.uniform(k_dir, (n, 3), minval=-1.0,
                                           maxval=1.0))
        return (torch.as_tensor(pick, dtype=torch.int64),
                torch.as_tensor(cube))

    def bounce(self, chunk, b, n, device):
        return rr_uniforms(jax.random.fold_in(self._keys(chunk)[2], b), n)


def rr_uniforms(key, n):
    """[3, n]: `_rr_bounce`'s u, theta and phi uniforms (split(key, 3))."""
    return torch.as_tensor(np.stack([
        np.array(jax.random.uniform(k, (n,)))
        for k in jax.random.split(key, 3)]))


def _surfaces(n, seed=0):
    """Random hit surfaces and materials as numpy: unit normals and
    incoming directions, front flags, t, and mixes of diffuse, reflective,
    refractive and absorbing materials (some channels zero)."""
    rng = np.random.RandomState(seed)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    def col(scale):
        c = rng.uniform(0, 1, (n, 3)) * scale
        return (c * (rng.uniform(size=(n, 1)) < 0.6)).astype(np.float32)
    surf = dict(n=unit(n), p=rng.uniform(-5, 5, (n, 3)).astype(np.float32),
                front=rng.uniform(size=n) < 0.7,
                t=rng.uniform(0.1, 20, n).astype(np.float32))
    mtl = dict(kd=col(1.0), ks=col(1.0), reflection=col(1.0),
               refraction=col(1.0), absorption=col(0.2),
               ior=rng.uniform(1.0, 2.0, n).astype(np.float32),
               gloss=rng.uniform(1, 100, n).astype(np.float32))
    return surf, mtl, unit(n)


def _thresholds(mtl, u, cfg, surf, d_in):
    """Per lane the distance of u * total from its nearest choice
    threshold, relative to total (float64, the reference's formulas)."""
    v = -d_in.astype(np.float64)
    nrm = surf["n"].astype(np.float64)
    ior = np.maximum(mtl["ior"], 1e-6).astype(np.float64)
    eta = np.where(surf["front"], 1.0 / ior, ior)
    cos_i = (nrm * v).sum(1)
    sin_i = np.sqrt(np.maximum(0.0, 1.0 - cos_i ** 2))
    c0 = (eta - 1.0) ** 2 / (eta + 1.0) ** 2
    r_c = c0 + (1.0 - c0) * (1.0 - np.abs(cos_i)) ** 5
    tot = eta * sin_i > cfg.total_reflection_threshold
    t_k, r_k = mtl["refraction"], mtl["reflection"]
    refr = np.where(tot[:, None], 0.0, t_k * (1.0 - r_c)[:, None])
    refl = np.where(tot[:, None], r_k + t_k, r_k + t_k * r_c[:, None])
    p = [refr.mean(1), refl.mean(1), mtl["kd"].mean(1)]
    total = np.maximum(p[0] + p[1] + p[2] + mtl["absorption"].mean(1),
                       1e-12)
    uu = u * total
    edges = np.cumsum(p, axis=0)
    return np.min(np.abs(uu[None] - edges), axis=0) / total


def test_rr_bounce_matches_jax():
    import jax.numpy as jnp
    from rtf_tpu.gi.photon import _rr_bounce as jbounce
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.gi.photon import _rr_bounce
    from rtf_tpu_torch.render.config import RenderConfig
    n = 4096
    surf, mtl, d_in = _surfaces(n)
    key = jax.random.PRNGKey(17)
    jsurf = SimpleNamespace(**{k: jnp.asarray(v) for k, v in surf.items()})
    jmtl = SimpleNamespace(**{k: jnp.asarray(v) for k, v in mtl.items()})
    want = [np.asarray(x) for x in jbounce(None, JConfig(), jsurf, jmtl,
                                           jnp.asarray(d_in), key)]
    psurf = SimpleNamespace(**{k: torch.as_tensor(v)
                               for k, v in surf.items()})
    pmtl = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in mtl.items()})
    u3 = rr_uniforms(key, n)
    got = [x.numpy() for x in _rr_bounce(RenderConfig(), psurf, pmtl,
                                         torch.as_tensor(d_in), u3)]
    near = _thresholds(mtl, u3[0].numpy().astype(np.float64),
                       RenderConfig(), surf, d_in) < 1e-6
    same = (got[2] == want[2]) & (got[3] == want[3])
    assert near.mean() <= 1e-3
    assert (same | near).all(), f"{int((~same & ~near).sum())} lanes differ"
    assert same.mean() > 0.99
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[same], w[same], rtol=1e-5, atol=1e-5)
    # every kind of choice occurs
    assert want[2].mean() < 0.9 and want[3].mean() > 0.1


def _sorted_map(pos, dirs, power, count):
    pos, dirs, power = (np.asarray(x)[:count] for x in (pos, dirs, power))
    key = np.round(pos, 2)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    return pos[order], dirs[order], power[order]


@pytest.mark.parametrize("case", ["box", "box_caustic", "mesh",
                                  "mesh_caustic", "capped"])
def test_shoot_photons_matches_jax(case):
    from rtf_tpu.gi.photon import shoot_photons as jshoot
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.gi.photon import shoot_photons
    from rtf_tpu_torch.render.config import RenderConfig
    mesh = case.startswith("mesh")
    caustic = case.endswith("caustic")
    jscene = dataclasses.replace(
        build_scene(box_scene(32, 24, with_mesh=mesh, mesh_subdiv=1)),
        mesh_algo="pallas_interpret")
    scene = port_scene_from_jax(jscene)
    n, cap = (4096, 3000) if case == "capped" else (4096, 16384)
    key = jax.random.PRNGKey(3)
    want = jshoot(jscene, JConfig(), n, cap, key, caustic_only=caustic,
                  chunk=2048)
    got = shoot_photons(scene, RenderConfig(), n, cap, JaxDraws(key),
                        caustic_only=caustic, chunk=2048)
    cw, cg = int(want.count), int(got.count)
    assert abs(cg - cw) <= 0.005 * cw, (cg, cw)
    assert cw > (50 if caustic else 2000)
    if case == "capped":
        assert cw == cg == cap
    m = min(cw, cg)
    a = _sorted_map(want.pos, want.dir, want.power, m)
    b = _sorted_map(got.pos.numpy(), got.dir.numpy(), got.power.numpy(), m)
    ok = (np.all(np.abs(a[0] - b[0]) <= 1e-3, axis=1)
          & np.all(np.abs(a[1] - b[1]) <= 1e-3, axis=1)
          & np.all(np.abs(a[2] - b[2]) <= 1e-4 * np.abs(a[2]) + 1e-9,
                   axis=1))
    assert ok.mean() >= 0.99, ok.mean()


def test_port_shooter_is_deterministic():
    from rtf_tpu_torch.gi.photon import shoot_photons
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(32, 24, mesh_subdiv=1), device="cpu")
    cfg = RenderConfig(photon_bounces=4)

    def shoot(seed):
        return shoot_photons(scene, cfg, 3000, 6000,
                             torch.Generator().manual_seed(seed), chunk=1024)
    a, b, c = shoot(7), shoot(7), shoot(8)
    assert int(a.count) == int(b.count) > 1000
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.pos, c.pos)
    n = int(a.count)
    assert torch.isfinite(a.power[:n]).all() and (a.power[:n] >= 0).all()
    assert (a.pos[n:] == 0).all()
