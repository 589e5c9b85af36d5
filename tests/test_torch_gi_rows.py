"""The wave's GI rows (render/wave.py::wave_plain with surf_out/gi_from,
through `wave` on CPU tensors) against interpret-mode
rtf_tpu.render.fused.fused_wave on the same tables, rays and seed.

Tolerances are the wave's: bounce 0 has equal hit masks, radiance within
atol 2e-4 and the surface rows (p within rtol 1e-4, as z; n, kd, k_eff
within atol) compared on the lanes that are alive and hit; the query
weight kd * k_eff is exactly 0 on lanes that missed.  Past bounce 0 a
rounding difference can flip a Russian-roulette choice, so at most 1% of
lanes may lie outside and the mean agrees within 1%.  The port writes zero
rows where a lane did not hit; JAX leaves them undefined there."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import port_scene_from_jax  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401

FLIP_SHARE = 0.01


def _cfg(**kw):
    from rtf_tpu.render.config import RenderConfig
    base = dict(min_samples=8, max_samples=8, bounces=1, shadow_min=1,
                shadow_max=1, gi_mode="none", split_mode="rr")
    base.update(kw)
    return RenderConfig(**base)


def _np_out(out):
    """(rad [3,N], hit, z, surf [12,N] or None, [query [9,N], ...])"""
    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        return np.stack([np.asarray(c) for c in x])
    rad3, hit, z, surf, queries = out
    return (arr(rad3), np.asarray(hit), np.asarray(z),
            None if surf is None else arr(surf),
            [np.concatenate([arr(q[0]), arr(q[1]), arr(q[2])])
             for q in queries])


def run_rows(desc, cfg, seed, seg=False, alive=None, child=False, **kw):
    """The JAX camera's rays (sample 0) through interpret-mode fused_wave
    (or fused_wave_seg) and the port's wave with the same row options.
    child=True seeds a child wave: throughput and absorption drawn from a
    numpy seed, rtype RT_REFRACT.  Returns (JAX, port) as `_np_out`."""
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu.render.fused import fused_wave, scene_consts
    from rtf_tpu.render.fused_seg import fused_wave_seg
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.utils.tracing import counter
    scene = build_scene(desc)
    w, h = scene.width, scene.height
    order = jnp.asarray(pixel_order(w, h))
    o3, d3 = primary_rays_ch(scene, order % w, order // w,
                             jnp.zeros_like(order))
    o3 = np.stack([np.asarray(x) for x in o3])
    d3 = np.stack([np.asarray(x) for x in d3])
    n = w * h
    alive = np.ones(n, bool) if alive is None else alive
    if child:
        rng = np.random.RandomState(seed % 1000)
        kw = dict(kw, tput3=rng.uniform(0.05, 1.0, (3, n)).astype(np.float32),
                  absorb3=rng.uniform(0.0, 0.5, (3, n)).astype(np.float32),
                  rtype=W.RT_REFRACT)
    jkw = {k: tuple(jnp.asarray(c) for c in v) if isinstance(v, np.ndarray)
           else v for k, v in kw.items()}
    args = (tuple(jnp.asarray(x) for x in o3),
            tuple(jnp.asarray(x) for x in d3), jnp.asarray(alive),
            jnp.int32(seed))
    if seg:
        ref = fused_wave_seg(cfg, scene_consts(scene), scene, *args, **jkw)
    else:
        ref = fused_wave(cfg, scene_consts(scene), *args, **jkw)
    tables = scene_tables(port_scene_from_jax(scene))
    assert tables.textured == seg
    pkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    keys = ("launches.wave_kernel", "launches.wave_kernel.textured")
    before = sum(map(counter, keys))
    port = W.wave(cfg, tables, torch.as_tensor(o3), torch.as_tensor(d3),
                  torch.as_tensor(alive), seed, **pkw)
    assert sum(map(counter, keys)) == before   # the plain version
    return _np_out(ref), _np_out(port)


def _flip_ok(a, b, atol, lanes=None):
    """At most FLIP_SHARE of the lanes outside atol, means within 1%."""
    if lanes is not None:
        a, b = a[:, lanes], b[:, lanes]
    off = (np.abs(a - b) > atol).any(0)
    assert off.mean() <= FLIP_SHARE, off.mean()
    assert abs(a.mean() - b.mean()) <= 0.01 * abs(b.mean()) + 1e-6


def _surface_close(port, ref, lanes, atol):
    """p (rtol 1e-4, as z), n, kd and k_eff or kd * k_eff rows on `lanes`."""
    np.testing.assert_allclose(port[0:3, lanes], ref[0:3, lanes], rtol=1e-4,
                               atol=atol)
    np.testing.assert_allclose(port[3:, lanes], ref[3:, lanes], atol=atol)


def assert_rows_close(ref, port, alive, gi_from, atol=2e-4):
    (rr, rh, rz, rs, rq), (pr, ph, pz, ps, pq) = ref, port
    np.testing.assert_array_equal(ph, rh)
    assert rh[alive].mean() > 0.5
    _flip_ok(pr, rr, atol)
    np.testing.assert_allclose(pz[rh], rz[rh], rtol=1e-4)
    assert len(pq) == len(rq)
    if rs is not None:
        assert ps.shape == (12, rh.shape[0])
        _surface_close(ps, rs, rh, atol)
        assert (ps[:, ~rh] == 0).all()
    for k, (q_ref, q_port) in enumerate(zip(rq, pq)):
        assert np.isfinite(q_port).all()
        if gi_from + k == 0:
            _surface_close(q_port, q_ref, rh, atol)
            for q in (q_ref, q_port):
                assert (q[6:9, ~rh] == 0).all()
        else:
            # lanes the port saw hit at this bounce (zero rows elsewhere)
            hit_k = (q_port[0:6] != 0).any(0)
            assert hit_k.any()
            _flip_ok(q_port[0:6], q_ref[0:6], atol, hit_k)
            _flip_ok(q_port[6:9], q_ref[6:9], atol)
        for q in (q_ref, q_port):
            assert (q[6:9, ~alive] == 0).all()


@pytest.mark.parametrize("gi_from", [1, 0])
def test_rows_match_fused_wave(gi_from):
    """The primary launch of a GI sample: first-hit surface rows and the
    query rows of bounces >= gi_from (1: the photon volume's, 0: with the
    caustic volume's at bounce 0)."""
    from rtf_tpu.scene.procedural import box_scene
    ref, port = run_rows(box_scene(32, 24, mesh_subdiv=1), _cfg(),
                         2 ** 31 - 5, surf_out=True, gi_from=gi_from)
    assert len(port[4]) == 2 - gi_from
    assert_rows_close(ref, port, np.ones(32 * 24, bool), gi_from)
