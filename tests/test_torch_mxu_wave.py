"""The port's wave on a mesh over 512 faces (render/wave.py::wave_plain on
the MXU tables, through `wave` on CPU tensors) against interpret-mode
rtf_tpu.render.fused.fused_wave with mesh_tables=mxu_tables(scene), at
bounce 0: hit masks equal, radiance within atol 2e-4 (test_fused.py:75),
z within rtol 1e-4.  Exact ties at equal t in two tiles may resolve
differently (the visit order is the lane's, not the 1024-lane block's),
which these tolerances allow."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402


def run_mxu(desc, cfg, seed, alive=None, seg=False):
    """The JAX camera's rays (sample 0), lane mask (default all alive) and
    seed through interpret-mode fused_wave (fused_wave_seg with seg=True)
    on the MXU tables and through the port's wave; returns ((rad [3, N],
    hit, z) JAX, (...) port, the port's inputs (tables, o3, d3, alive))."""
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu.render.fused import fused_wave, mxu_tables, scene_consts
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
    if alive is None:
        alive = np.ones(w * h, bool)
    args = (scene_consts(scene), o3, d3, jnp.asarray(alive),
            jnp.int32(seed))
    if seg:
        out = fused_wave_seg(cfg, args[0], scene, *args[1:],
                             mesh_tables=mxu_tables(scene))
    else:
        out = fused_wave(cfg, *args, mesh_tables=mxu_tables(scene))
    ref = (np.stack([np.asarray(c) for c in out[0]]), np.asarray(out[1]),
           np.asarray(out[2]))
    tables = scene_tables(port_scene_from_jax(scene))
    assert tables.mxu and tables.textured == seg
    inputs = (tables, torch.as_tensor(np.stack([np.asarray(x) for x in o3])),
              torch.as_tensor(np.stack([np.asarray(x) for x in d3])),
              torch.as_tensor(alive))
    keys = ("launches.wave_kernel.mxu", "launches.wave_kernel.textured_mxu")
    counts = tuple(map(counter, keys))
    prad, phit, pz = W.wave(cfg, *inputs, seed)
    assert tuple(map(counter, keys)) == counts
    return ref, (prad.numpy(), phit.numpy(), pz.numpy()), inputs


def _cfg(**kw):
    from rtf_tpu.render.config import RenderConfig
    base = dict(min_samples=8, max_samples=8, bounces=0, shadow_min=1,
                shadow_max=1, gi_mode="none")
    base.update(kw)
    return RenderConfig(**base)


def assert_bounce0(ref, port, alive=slice(None), atol=2e-4):
    (rr, rh, rz), (pr, ph, pz) = ref, port
    np.testing.assert_array_equal(ph, rh)
    assert rh[alive].mean() > 0.5
    np.testing.assert_allclose(pr, rr, atol=atol)
    np.testing.assert_allclose(pz[rh], rz[rh], rtol=1e-4)
    assert pr.max() > 0.05


def test_mxu_wave_bounce0_box():
    """box_scene(mesh_subdiv=3): the 1280-face ball, 10 tiles; every other
    lane dead."""
    from rtf_tpu.scene.procedural import box_scene
    alive = np.ones(32 * 24, bool)
    alive[::2] = False
    ref, port, _ = run_mxu(box_scene(32, 24, mesh_subdiv=3), _cfg(), 123,
                           alive=alive)
    assert_bounce0(ref, port, alive)
    for rad, hit in ((ref[0], ref[1]), (port[0], port[1])):
        assert not hit[~alive].any()
        assert (rad[:, ~alive] == 0).all()
    # the ball is in view and shades: lanes with its z differ from walls
    assert (np.abs(port[0][0] - port[0][1]) > 0.1).mean() > 0.01


def test_mxu_wave_bounce0_two_slots():
    """Two mesh slots, each instanced twice (tile ranges per instance, a
    rotated instance)."""
    from test_torch_mxu_pack import two_slot_desc
    ref, port, _ = run_mxu(two_slot_desc(), _cfg(), 2 ** 31 - 5)
    assert_bounce0(ref, port)
