"""The port's MXU mesh tables (ops/mxu_pack.py, render/scene_tables.py)
against rtf_tpu.render.fused._mxu_pack, and the GI child-ray permutation
(render/gi.py::gi_mesh_perm) against fused.py::_gi_mesh_perm.  Both are
host-side NumPy/tensor code on the same inputs, so they must agree
exactly: every Plücker and shade value, tile box and visit order, and
every lane of the permutation."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402


def two_slot_desc(port=False, w=32, h=24):
    """Two mesh slots (icospheres of 320 and 1280 faces, 1600 in all: the
    MXU tables), each instanced twice with different transforms."""
    if port:
        from rtf_tpu_torch.core.transform import Transform
        from rtf_tpu_torch.scene.procedural import (
            _node, box_scene, icosphere_mesh)
    else:
        from rtf_tpu.core.transform import Transform
        from rtf_tpu.scene.procedural import _node, box_scene, icosphere_mesh
    desc = box_scene(w, h, with_mesh=False)
    small, big = icosphere_mesh(2), icosphere_mesh(3)
    for name, mesh, tf in (
            ("s0", small, Transform().scale(2).translate([-3, 2, 2])),
            ("s1", small, Transform().scale(1.5).translate([4, 6, 8])),
            ("b0", big, Transform().scale(3).translate([1, 4, 3])),
            ("b1", big, Transform().scale(2).rotate([0, 0, 1], 30)
             .translate([-6, 10, 14]))):
        desc.root.children.append(_node(name, "mesh", "redball", tf,
                                        mesh=mesh))
    return desc


def _scene(name):
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    desc = box_scene(32, 24, mesh_subdiv=3) if name == "box" \
        else two_slot_desc()
    return build_scene(desc)


@pytest.mark.parametrize("name", ["box", "two_slots"])
def test_mxu_tables_equal_mxu_pack(name):
    from rtf_tpu.render.fused import MXU_TILE, _mxu_pack, scene_mesh_mode
    from rtf_tpu_torch.ops.mxu_pack import mesh_mxu_pack
    from rtf_tpu_torch.render.scene_tables import (
        TILE_PAD, mesh_mode, scene_tables)
    scene = _scene(name)
    assert scene_mesh_mode(scene) == "mxu"
    ref = _mxu_pack(scene)
    pscene = port_scene_from_jax(scene)
    assert mesh_mode(pscene) == "mxu"
    pack = mesh_mxu_pack(pscene.mesh)
    faces, tiles = pack["faces"], pack["tiles"]
    nt = ref["trit"].shape[0]
    assert faces.shape == (nt * MXU_TILE, 40) and tiles.shape == (nt, 16)
    f3 = faces.reshape(nt, MXU_TILE, 40)
    trit, shade = ref["trit"], ref["shade"]
    for k in range(3):          # w_a, w_b, w_c against the sign blocks
        np.testing.assert_array_equal(
            f3[:, :, 6 * k:6 * k + 6],
            trit[:, 0:6, k * MXU_TILE:(k + 1) * MXU_TILE].transpose(0, 2, 1))
    np.testing.assert_array_equal(                         # n
        f3[:, :, 18:21],
        trit[:, 0:3, 3 * MXU_TILE:4 * MXU_TILE].transpose(0, 2, 1))
    np.testing.assert_array_equal(                         # -n and n . a
        -f3[:, :, 18:21],
        trit[:, 6:9, 4 * MXU_TILE:5 * MXU_TILE].transpose(0, 2, 1))
    np.testing.assert_array_equal(f3[:, :, 21],
                                  trit[:, 9, 4 * MXU_TILE:5 * MXU_TILE])
    # the shade columns: normals, material, geometric normal, uv
    np.testing.assert_array_equal(f3[:, :, 22:32], shade[:, :, 0:10])
    np.testing.assert_array_equal(f3[:, :, 18:21], shade[:, :, 10:13])
    np.testing.assert_array_equal(f3[:, :, 32:38], shade[:, :, 13:19])
    # tile boxes and all eight visit orders
    np.testing.assert_array_equal(tiles[:, 0:14], ref["aabb"][:, 0:14])
    assert pack["slots"] == ref["slots"]
    # face ranges: tile j's faces start at row 128 j
    np.testing.assert_array_equal(tiles[:, 14], np.arange(nt) * MXU_TILE)
    for slot, (row0, nts, _, _) in ref["slots"].items():
        f0, f1 = scene.mesh.slot_faces[slot]
        assert tiles[row0:row0 + nts, 15].sum() == f1 - f0
    # the wave's tables: the tiles as tnodes rows with padded boxes, the
    # face ranges and the ranks that invert the visit orders; per instance
    # its slot's tiles
    tab = scene_tables(pscene)
    assert tab.mxu and tab.textured is False and not hasattr(tab, "tiles")
    t = tab.tnodes.numpy()
    np.testing.assert_array_equal(t[:, 6:8], tiles[:, 14:16])
    for slot, (row0, nts, _, _) in ref["slots"].items():
        for o in range(8):
            order = tiles[row0:row0 + nts, 6 + o].astype(np.int64)
            np.testing.assert_array_equal(t[order, 8 + o],
                                          row0 + np.arange(nts))
    full = tiles[:, 0] <= tiles[:, 3]
    assert (t[full, 0:3] < tiles[full, 0:3]).all()
    assert (t[full, 3:6] > tiles[full, 3:6]).all()
    pad = t[full, 3:6] - tiles[full, 3:6]
    assert (pad <= TILE_PAD * 2 * (1 + np.abs(tiles[full, 0:6]).max())).all()
    insts = tab.mesh_insts.numpy()
    for i, slot in enumerate(pscene.mesh_inst_slots):
        row0, nts, lo, hi = ref["slots"][slot]
        assert tuple(insts[i, 22:24]) == (row0, nts)
        assert tab.mesh_bounds[i] == (lo, hi)
        assert (tab.roots[i, 0:3].numpy() < np.asarray(lo)).all()
        assert (tab.roots[i, 3:6].numpy() > np.asarray(hi)).all()


@pytest.mark.parametrize("name", ["box", "two_slots"])
def test_gi_mesh_perm_matches(name):
    """The same child origins, directions and live lanes (numpy seed: half
    the origins near the instances, directions over the sphere, a quarter
    of the lanes dead) give the same permutation and inverse."""
    import jax.numpy as jnp
    from rtf_tpu.render.fused import _gi_mesh_perm, scene_consts
    from rtf_tpu_torch.render.gi import gi_mesh_perm
    from rtf_tpu_torch.render.scene_tables import scene_tables
    scene = _scene(name)
    tab = scene_tables(port_scene_from_jax(scene))
    rng = np.random.RandomState(7)
    n = 3000
    lo, hi = np.asarray(scene.world_min), np.asarray(scene.world_max)
    o3 = rng.uniform(lo, hi, (n, 3)).T.astype(np.float32)
    o3[:, ::2] = (np.array([[1.0], [4.0], [15.0]])
                  + rng.normal(0, 4, (3, n))[:, ::2]).astype(np.float32)
    d3 = rng.normal(size=(3, n))
    d3 = (d3 / np.linalg.norm(d3, axis=0)).astype(np.float32)
    d3[0, 5:40] = 0.0                        # axis-parallel directions
    alive = rng.rand(n) > 0.25
    perm, inv = _gi_mesh_perm(scene_consts(scene),
                              tuple(jnp.asarray(x) for x in o3),
                              tuple(jnp.asarray(x) for x in d3),
                              jnp.asarray(alive))
    pperm, pinv = gi_mesh_perm(tab, torch.as_tensor(o3), torch.as_tensor(d3),
                               torch.as_tensor(alive))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(pinv.numpy(), np.asarray(inv))
    # a real grouping: the lanes move, and the dead ones sort last
    p = pperm.numpy()
    assert not np.array_equal(p, np.arange(n))
    assert not alive[p[alive.sum():]].any()


def test_large_mesh_takes_the_fused_path(monkeypatch):
    """Up to rtf_tpu's streaming budget a large mesh is the fused path's;
    above it (fused.py:422-425) the wavefront's, as in rtf_tpu."""
    from rtf_tpu_torch.render import scene_tables as ST
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(8, 6, mesh_subdiv=3), device="cpu")
    cfg = RenderConfig(min_samples=8, max_samples=8, bounces=0,
                       shadow_min=1, shadow_max=1)
    assert ST.render_path(scene, cfg) == ("fused", None)
    assert ST.render_path(scene, cfg.with_(split_mode="both"))[0] \
        == "wavefront"
    monkeypatch.setattr(ST, "MXU_STREAM_MAX_FACES", 1000)
    path, why = ST.render_path(scene, cfg)
    assert path == "wavefront" and "streaming budget" in why
