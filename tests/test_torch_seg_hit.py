"""The port's closest hit with uv (render/wave.py::_closest_hit, the part of
the wave that replaces rtf_tpu's `_seg_hit_kernel`) against that Pallas
kernel in interpret mode, on the textured box's primary rays and on 1024
seeded rays from inside the box.

The test builds the `pallas_call` as fused_seg.py::fused_wave_seg does
(fused_seg.py:409-425, 441-491), immediates mesh (no mesh tables).  Both
sides run the same float32 operations in the same order, so no tie lane
may differ: hit masks, mtl and front are equal on every lane, t within
rtol 1e-4, normals and uv within atol 2e-4."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_common import port_scene_from_jax, textured_desc  # noqa: E402


@pytest.fixture(scope="module")
def scenes():
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.render.scene_tables import scene_tables
    jscene = build_scene(textured_desc(port=False))
    return jscene, scene_tables(port_scene_from_jax(jscene))


def seg_hit_rows(jscene, o3, d3):
    """Interpret-mode _seg_hit_kernel on all-alive rays [3, n] (numpy):
    rows t, nx, ny, nz, mtl, front, u, v as [8, n]."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from rtf_tpu.ops.pallas_mesh import TRI_LANES
    from rtf_tpu.render.fused import (
        BLOCK, R_ALIVE, R_D, R_O, SENTINEL, SUB, _blk4, _pack_rays_sh,
        _pad_blocks, scene_consts)
    from rtf_tpu.render.fused_seg import HIT_ROWS, _seg_hit_kernel
    n0 = o3.shape[1]
    n = _pad_blocks(n0)
    nblk = n // BLOCK

    def padded(x, fill):
        return jnp.concatenate([jnp.asarray(x),
                                jnp.full((n - n0,), fill, jnp.float32)])
    cols = {R_ALIVE: padded(np.ones(n0, np.float32), 0.0)}
    for c in range(3):
        cols[R_O + c] = padded(o3[c], SENTINEL)
        cols[R_D + c] = padded(d3[c], 1.0)
    kern = functools.partial(_seg_hit_kernel, consts=scene_consts(jscene),
                             has_mesh_tables=False, stream_mesh=False)
    hit = pl.pallas_call(
        kern, grid=(nblk,),
        out_shape=jax.ShapeDtypeStruct((nblk, HIT_ROWS, SUB, TRI_LANES),
                                       jnp.float32),
        in_specs=[_blk4(16)], out_specs=_blk4(HIT_ROWS),
        scratch_shapes=[pltpu.VMEM((9, SUB, TRI_LANES), jnp.float32)],
        interpret=True,
    )(_pack_rays_sh(cols))
    rows = np.asarray(hit).transpose(1, 0, 2, 3).reshape(HIT_ROWS, n)
    assert (rows[8, :n0] == -1).all()          # no deferred face ids
    return rows[:8, :n0]


def _compare(jscene, tables, o3, d3):
    from rtf_tpu_torch.render import wave as W
    ref = seg_hit_rows(jscene, o3, d3)
    t, n3, mtl, front, uv = W._closest_hit(
        W._Host(tables), tuple(torch.as_tensor(x) for x in o3),
        tuple(torch.as_tensor(x) for x in d3), True)
    port = np.stack([x.numpy() for x in (t, *n3, mtl, front, *uv)])
    hit = ref[0] < 1e29
    np.testing.assert_array_equal(port[0] < 1e29, hit)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(port[4:6, hit], ref[4:6, hit])
    np.testing.assert_allclose(port[0, hit], ref[0, hit], rtol=1e-4)
    np.testing.assert_allclose(port[1:4, hit], ref[1:4, hit], atol=2e-4)
    np.testing.assert_allclose(port[6:8, hit], ref[6:8, hit], atol=2e-4)
    return ref, hit


def test_hit_rows_primary(scenes):
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    jscene, tables = scenes
    import jax.numpy as jnp
    w, h = jscene.width, jscene.height
    order = jnp.asarray(pixel_order(w, h))
    o3, d3 = primary_rays_ch(jscene, order % w, order // w,
                             jnp.zeros_like(order))
    ref, hit = _compare(jscene, tables, np.stack([np.asarray(x) for x in o3]),
                        np.stack([np.asarray(x) for x in d3]))
    # walls, the mirror sphere and the textured ball all seen
    mtl = set(ref[4, hit].astype(int).tolist())
    assert len(mtl) >= 5


def test_hit_rows_inside_box(scenes):
    """Rays from inside the box in every direction: back faces, rays that
    start inside a sphere, the ball's uv seam and the open front."""
    jscene, tables = scenes
    rng = np.random.RandomState(17)
    n = 1024
    o3 = np.stack([rng.uniform(-14, 14, n), rng.uniform(-15, 19, n),
                   rng.uniform(1, 23, n)]).astype(np.float32)
    d3 = rng.normal(size=(3, n))
    d3 = (d3 / np.linalg.norm(d3, axis=0)).astype(np.float32)
    ref, hit = _compare(jscene, tables, o3, d3)
    assert (~hit).any() and (ref[5, hit] == 0).any()   # misses, back hits
