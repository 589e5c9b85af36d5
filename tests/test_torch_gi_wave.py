"""One GI sample wave (render/gi.py::gi_wave: the primary launch with its
surface rows, then hemisphere child launches) against interpret-mode
rtf_tpu.render.fused.fused_gi_wave, fed the reference's own hemisphere
draws (jax.random, drawn as fused_gi_chunks draws them).  Hit masks are
equal; a rounding difference can flip a Russian-roulette choice in the
primary or a child wave, so at most 1% of lanes may lie outside atol 2e-4
and the mean radiance agrees within 1%."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import port_scene_from_jax  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_rows import _cfg  # noqa: E402


def reference_draws(key, n_samples, n):
    """The uniforms fused_gi_chunks gives hemisphere sample i:
    split(fold_in(key, i)) -> (u_phi, ysq)."""
    out = []
    for i in range(n_samples):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        out.append((torch.as_tensor(np.array(jax.random.uniform(k1, (n,)))),
                    torch.as_tensor(np.array(jax.random.uniform(k2, (n,))))))
    return out


def volume_pair(bounds_min, bounds_max, dims, seed):
    """The same irradiance volume for both packages: E in [0, 0.5) and
    mean directions in [-1, 1) from a numpy seed, spanning the bounds."""
    import jax.numpy as jnp
    from rtf_tpu.gi.volume import IrradianceVolume
    from rtf_tpu_torch.gi.volume import volume_from_arrays
    rng = np.random.RandomState(seed)
    nc = int(np.prod([d + 1 for d in dims]))
    table = np.concatenate([rng.uniform(0.0, 0.5, (3, nc)),
                            rng.uniform(-1.0, 1.0, (3, nc))]).astype(
                                np.float32)
    lo = np.asarray(bounds_min, np.float32)
    cell = float(np.max((np.asarray(bounds_max) - lo) / np.asarray(dims)))
    ref = IrradianceVolume(table=jnp.asarray(table), origin=jnp.asarray(lo),
                           dims=tuple(dims), cell=cell)
    return ref, volume_from_arrays(table, lo, dims, cell, device="cpu")


def run_gi(desc, cfg, seed, key_seed, volumes=False):
    """Both GI waves on the JAX camera's rays (sample 0); with
    volumes=True a photon and a caustic volume.  Returns ((rad [3,N],
    hit, z) JAX, (...) port, the port's radiance without GI)."""
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu.render.fused import fused_gi_wave, scene_consts
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.gi import gi_wave
    from rtf_tpu_torch.render.scene_tables import scene_tables
    scene = build_scene(desc)
    w, h = scene.width, scene.height
    n = w * h
    order = jnp.asarray(pixel_order(w, h))
    o3, d3 = primary_rays_ch(scene, order % w, order // w,
                             jnp.zeros_like(order))
    alive = jnp.ones((n,), bool)
    key = jax.random.PRNGKey(key_seed)
    vols = [(None, None), (None, None)]
    if volumes:
        vols = [volume_pair(scene.world_min, scene.world_max, (8, 8, 6), s)
                for s in (0, 1)]
    rad3, hit, z = fused_gi_wave(cfg, scene_consts(scene), o3, d3, alive,
                                 jnp.int32(seed), key, gi_vol=vols[0][0],
                                 caustic_vol=vols[1][0])
    ref = (np.stack([np.asarray(c) for c in rad3]), np.asarray(hit),
           np.asarray(z))
    tables = scene_tables(port_scene_from_jax(scene))
    po3 = torch.as_tensor(np.stack([np.asarray(x) for x in o3]))
    pd3 = torch.as_tensor(np.stack([np.asarray(x) for x in d3]))
    palive = torch.ones(n, dtype=torch.bool)
    prad, phit, pz = gi_wave(cfg, tables, po3, pd3, palive, seed,
                             reference_draws(key, cfg.hemisphere_samples, n),
                             gi_vol=vols[0][1], caustic_vol=vols[1][1])
    direct = W.wave_plain(cfg, tables, po3, pd3, palive, seed)[0]
    return ref, (prad.numpy(), phit.numpy(), pz.numpy()), direct.numpy()


def assert_gi_close(ref, port, direct):
    (rr, rh, rz), (pr, ph, pz) = ref, port
    np.testing.assert_array_equal(ph, rh)
    assert rh.mean() > 0.5 and np.isfinite(pr).all()
    np.testing.assert_allclose(pz[rh], rz[rh], rtol=1e-4)
    off = (np.abs(pr - rr) > 2e-4).any(0).mean()
    assert off <= 0.01, off
    assert abs(pr.mean() - rr.mean()) <= 0.01 * rr.mean()
    # GI adds light on top of the same primary wave
    assert pr.mean() > direct.mean() * 1.05


def test_gi_wave_hemisphere_matches_fused_gi_wave():
    from rtf_tpu.scene.procedural import box_scene
    cfg = _cfg(gi_mode="hemisphere", hemisphere_samples=2)
    assert cfg.gi_stratify
    assert_gi_close(*run_gi(box_scene(32, 24, mesh_subdiv=1), cfg,
                            2 ** 31 - 5, 3))
