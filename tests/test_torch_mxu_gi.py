"""GI child waves on the MXU tables: render/gi.py::gi_chunks, whose child
lanes go through gi_mesh_perm, against interpret-mode
rtf_tpu.render.fused.fused_gi_chunks (which applies _gi_mesh_perm), per
lane, on the reference's own first-hit surface rows and its own
hemisphere draws (jax.random, as fused_gi_chunks draws them).  The
permutation decides which lane's hash-RNG stream traces each child ray, so
the child waves agree per lane only where it is reproduced: at most 1% of
lanes outside atol 2e-4 (a rounding flip of a Russian-roulette choice) and
the mean within 1%."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402
from test_torch_gi_rows import _cfg  # noqa: E402
from test_torch_gi_wave import reference_draws, volume_pair  # noqa: E402


def test_gi_chunks_with_the_mesh_permutation():
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu.render.fused import (
        fused_gi_chunks, fused_gi_primary, mxu_tables, scene_consts)
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.render import gi as G
    from rtf_tpu_torch.render.scene_tables import scene_tables
    scene = build_scene(box_scene(32, 24, mesh_subdiv=3))
    cfg = _cfg(gi_mode="photon", hemisphere_samples=2, photon_volume=True,
               bounces=3)
    assert cfg.gi_mesh_sort
    w, h = scene.width, scene.height
    n = w * h
    order = jnp.asarray(pixel_order(w, h))
    o3, d3 = primary_rays_ch(scene, order % w, order // w,
                             jnp.zeros_like(order))
    alive = jnp.ones((n,), bool)
    consts, mt = scene_consts(scene), mxu_tables(scene)
    vol, pvol = volume_pair(scene.world_min, scene.world_max, (8, 8, 6), 0)
    _, hit0, _, surf = fused_gi_primary(cfg, consts, o3, d3, alive,
                                        jnp.int32(5), gi_vol=vol,
                                        mesh_tables=mt)
    key = jax.random.PRNGKey(11)
    ref = fused_gi_chunks(cfg, consts, surf, hit0, alive, jnp.int32(5), key,
                          jnp.int32(0), cfg.hemisphere_samples, gi_vol=vol,
                          mesh_tables=mt)
    ref = np.stack([np.asarray(c) for c in ref])

    tables = scene_tables(port_scene_from_jax(scene))
    calls = []
    perm_fn = G.gi_mesh_perm

    def counted(*a):
        calls.append(1)
        return perm_fn(*a)
    draws = reference_draws(key, cfg.hemisphere_samples, n)
    args = (tables, torch.as_tensor(np.stack([np.asarray(x) for x in surf])),
            torch.as_tensor(np.array(hit0)),
            torch.ones(n, dtype=torch.bool), 5, draws)
    G.gi_mesh_perm = counted
    try:
        port = G.gi_chunks(cfg, *args, gi_vol=pvol).numpy()
    finally:
        G.gi_mesh_perm = perm_fn
    assert len(calls) == cfg.hemisphere_samples
    off = (np.abs(port - ref) > 2e-4).any(0)
    assert off.mean() <= 0.01, off.mean()
    assert ref.mean() > 0.01
    assert abs(port.mean() - ref.mean()) <= 0.01 * ref.mean()
    # without the permutation the lanes draw other RNG streams
    unsorted = G.gi_chunks(cfg.with_(gi_mesh_sort=False), *args,
                           gi_vol=pvol).numpy()
    assert (np.abs(unsorted - ref) > 2e-4).any(0).mean() > 10 * off.mean()
