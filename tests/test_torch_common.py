"""Shared helpers of the PyTorch port's tests, and the port's own rules:
no JAX in the port, entry points default to the card, and scenes outside
the ported slice are refused.

The helpers build the same scene description with either package and
carry a JAX GpuScene across to the port as numpy arrays.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def checker_desc(w=32, h=24, port=True):
    """test_fused_seg._textured_desc without its file texture, as a
    checker scene: the checker on names[1]'s kd, plus a scaled checker on
    the walls' kd (planes) and on the mirror's ks (sphere uv)."""
    if port:
        from rtf_tpu_torch.core.transform import Transform
        from rtf_tpu_torch.scene.model import (
            TexMapDesc, TextureDesc, TexturedColorDesc)
        from rtf_tpu_torch.scene.procedural import box_scene
    else:
        from rtf_tpu.core.transform import Transform
        from rtf_tpu.scene.model import (
            TexMapDesc, TextureDesc, TexturedColorDesc)
        from rtf_tpu.scene.procedural import box_scene
    desc = box_scene(width=w, height=h, with_mesh=False)
    chk = TextureDesc(kind="checker", name="c",
                      color1=np.array([0.1, 0.1, 0.1]),
                      color2=np.array([0.9, 0.8, 0.2]))
    names = sorted(desc.materials)
    m1 = desc.materials[names[1]]
    m1.diffuse = TexturedColorDesc(m1.diffuse.color, TexMapDesc(chk))
    wall = desc.materials["wall"]
    wall.diffuse = TexturedColorDesc(
        wall.diffuse.color, TexMapDesc(chk, Transform().scale(0.25)))
    mirror = desc.materials["mirror"]
    mirror.specular = TexturedColorDesc(
        mirror.specular.color,
        TexMapDesc(chk, Transform().scale(0.125).translate([0.1, 0.0, 0.0])))
    return desc


def textured_desc(w=32, h=24, port=True, seed=0, mesh_subdiv=1,
                  background=False):
    """The textured box (chip_smoke.py::textured_desc builds the same):
    box_scene(w, h, with_mesh=True) with file texture A (512x512) on the
    walls' kd through Transform().scale(0.25) (plane uv, tiling), file
    texture B (256x256) on the ball's kd (mesh uv; the icosphere gets
    spherical vertex uv), checker_desc's scaled checker on the mirror's ks
    (sphere uv) and file texture C (512x512) as the environment map with
    colour (1, 1, 1).  Textures are float32 in [0, 1) from
    np.random.RandomState(seed), drawn in the order A, B, C.
    `background` adds texture A, scaled by 0.5, as the background map
    with colour (0.8, 0.9, 1.0)."""
    if port:
        from rtf_tpu_torch.core.transform import Transform
        from rtf_tpu_torch.scene.model import (
            TexMapDesc, TextureDesc, TexturedColorDesc)
        from rtf_tpu_torch.scene.procedural import box_scene
    else:
        from rtf_tpu.core.transform import Transform
        from rtf_tpu.scene.model import (
            TexMapDesc, TextureDesc, TexturedColorDesc)
        from rtf_tpu.scene.procedural import box_scene
    desc = box_scene(w, h, with_mesh=True, mesh_subdiv=mesh_subdiv)
    rng = np.random.RandomState(seed)
    tex_a, tex_b, tex_c = (
        TextureDesc(kind="file", name=name,
                    data=rng.rand(n, n, 3).astype(np.float32))
        for name, n in (("A", 512), ("B", 256), ("C", 512)))
    chk = TextureDesc(kind="checker", name="c",
                      color1=np.array([0.1, 0.1, 0.1]),
                      color2=np.array([0.9, 0.8, 0.2]))
    wall = desc.materials["wall"]
    wall.diffuse = TexturedColorDesc(
        wall.diffuse.color, TexMapDesc(tex_a, Transform().scale(0.25)))
    ball = desc.materials["redball"]
    ball.diffuse = TexturedColorDesc(ball.diffuse.color, TexMapDesc(tex_b))
    mirror = desc.materials["mirror"]
    mirror.specular = TexturedColorDesc(
        mirror.specular.color,
        TexMapDesc(chk, Transform().scale(0.125).translate([0.1, 0.0, 0.0])))
    desc.environment = TexturedColorDesc(np.ones(3), TexMapDesc(tex_c))
    if background:
        desc.background = TexturedColorDesc(
            np.array([0.8, 0.9, 1.0]),
            TexMapDesc(tex_a, Transform().scale(0.5)))
    mesh = next(n.mesh for n in desc.root.children if n.obj_kind == "mesh")
    v = mesh.v.astype(np.float64)
    mesh.vt = np.stack([0.5 + np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi),
                        0.5 + np.arcsin(np.clip(v[:, 2], -1, 1)) / np.pi,
                        np.zeros(len(v))], axis=1).astype(np.float32)
    mesh.ft = mesh.f.copy()
    return desc


def mxu_walk_desc(case, w=32, h=24, subdiv=3):
    """The port's box without its ball, plus icosphere balls of `subdiv`
    (3: 1280 faces, the MXU tables; 1: 80, the immediates) for the edge
    cases of the kernels' hierarchical walk:
    "tie": one ball whose faces are each listed twice, after one tiny far
      face at the low corner that Morton order puts first, so each pair
      of copies is tied at equal t and one pair straddles every 128-face
      tile boundary (the stable Morton sort keeps copies adjacent);
    "twin": the ball in two slots at one transform (every hit tied across
      instances: the first instance keeps it);
    "two": one ball instanced twice, the second rotated and moved;
    "degenerate": one ball with a zero-area copy (two equal vertices) of
      every 7th face, which Morton order puts among the others and the
      immediates tables drop."""
    from rtf_tpu_torch.core.transform import Transform
    from rtf_tpu_torch.scene.procedural import (
        _node, box_scene, icosphere_mesh)
    desc = box_scene(w, h, with_mesh=False)
    place = Transform().scale(3).translate([1, 4, 3])
    ball = icosphere_mesh(subdiv)
    if case == "degenerate":
        flat = ball.f[::7].copy()
        flat[:, 2] = flat[:, 1]
        ball.f = np.concatenate([ball.f, flat]).astype(np.int32)
        ball.face_mtl = np.zeros(len(ball.f), np.int32)
        ball.compute_normals()
        nodes = [("ball", ball, place)]
    elif case == "tie":
        nv = len(ball.v)
        ball.v = np.concatenate([ball.v, np.array(
            [[-1.5, -1.5, -1.5], [-1.49, -1.5, -1.5], [-1.5, -1.49, -1.5]],
            np.float32)])
        ball.f = np.concatenate([[[nv, nv + 1, nv + 2]], ball.f, ball.f]
                                ).astype(np.int32)
        ball.face_mtl = np.zeros(len(ball.f), np.int32)
        ball.compute_normals()
        nodes = [("ball", ball, place)]
    elif case == "twin":
        nodes = [("ball", ball, place),
                 ("twin", icosphere_mesh(subdiv), place)]
    else:
        nodes = [("ball", ball, place),
                 ("ball2", ball, Transform().scale(2.5).rotate([0, 0, 1], 40)
                  .rotate([1, 0, 0], 25).translate([-6, 8, 14]))]
    for name, mesh, tf in nodes:
        desc.root.children.append(_node(name, "mesh", "redball", tf,
                                        mesh=mesh))
    return desc


def face_rays(scene, dev, offset=2.0):
    """[3, N] origins and directions of one ray per non-degenerate face
    of the scene's first mesh instance: from `offset` outside the face's
    centroid along its world-space normal, straight back at it."""
    mesh = scene.mesh
    f0, f1 = mesh.slot_faces[int(scene.mesh_inst_slots[0])]
    a, b, c = (getattr(mesh, k)[f0:f1].cpu().double() for k in
               ("tri_a", "tri_b", "tri_c"))
    n = torch.linalg.cross(b - a, c - a)
    keep = n.norm(dim=1) > 1e-12
    itm = scene.mesh_inst.itm[0].cpu().double()
    ctr = ((a + b + c) / 3.0)[keep] @ torch.linalg.inv(itm).T \
        + scene.mesh_inst.pos[0].cpu().double()
    nw = n[keep] @ itm
    nw = nw / nw.norm(dim=1, keepdim=True)
    o = (ctr + offset * nw).float().T.contiguous().to(dev)
    d = (-nw).float().T.contiguous().to(dev)
    return o, d


def vertex_rays(scene, dev, seed=0):
    """[3, N] origins and directions of one ray per face vertex of the
    scene's first mesh instance: from a seeded point about 3 outside the
    vertex straight at it.  A hit on a vertex lies on the faces of its
    leaf, tile and group boxes, where only their padding keeps the slab
    entry below t."""
    mesh = scene.mesh
    f0, f1 = mesh.slot_faces[int(scene.mesh_inst_slots[0])]
    v = torch.cat([getattr(mesh, k)[f0:f1].cpu() for k in
                   ("tri_a", "tri_b", "tri_c")]).double()
    inv = torch.linalg.inv(scene.mesh_inst.itm[0].cpu().double())
    vw = v @ inv.T + scene.mesh_inst.pos[0].cpu().double()
    out = v / v.norm(dim=1, keepdim=True).clamp(min=1e-12)
    jitter = torch.as_tensor(np.random.RandomState(seed).normal(
        0, 0.3, tuple(v.shape)))
    o = vw + 3.0 * (out @ inv.T) + jitter
    d = (vw - o) / (vw - o).norm(dim=1, keepdim=True)
    return (o.float().T.contiguous().to(dev),
            d.float().T.contiguous().to(dev))


def icosphere_faces(subdiv, shift=0.0):
    """The port's icosphere as face corners (a, b, c), each [F, 3] float32
    numpy, moved by `shift` along every axis."""
    from rtf_tpu_torch.scene.procedural import icosphere_mesh
    m = icosphere_mesh(subdiv)
    return tuple((m.v[m.f[:, k]] + np.float32(shift)).astype(np.float32)
                 for k in range(3))


def dense_rays(kind, a, b, c, seed=0, n=4096):
    """Rays (o, d) [N, 3] float32 numpy at the faces (a, b, c) for the
    dense Plücker closest hit: "edge" one ray per face at the midpoint of
    its edge (face % 3), "vertex" one per face at its corner (face % 3),
    each from about 3 outside that point (seeded jitter) straight at it;
    "scattered" n rays with origins uniform in twice the faces' box about
    its centre and uniform directions."""
    rng = np.random.RandomState(seed)
    corners = np.stack([a, b, c], 1).astype(np.float64)
    ctr = corners.reshape(-1, 3).mean(0)
    if kind == "scattered":
        lo, hi = corners.reshape(-1, 3).min(0), corners.reshape(-1, 3).max(0)
        o = ctr + (hi - lo) * rng.uniform(-1.0, 1.0, (n, 3))
        d = rng.normal(size=(n, 3))
    else:
        f = np.arange(len(a))
        k = f % 3
        p = corners[f, k]
        if kind == "edge":
            p = 0.5 * (p + corners[f, (k + 1) % 3])
        out = p - ctr
        out /= np.linalg.norm(out, axis=1, keepdims=True)
        o = p + 3.0 * out + rng.normal(0.0, 0.3, p.shape)
        d = p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture
def one_torch_thread():
    """Run the test's PyTorch CPU ops on one thread: the port's tests use
    small tensors, and with several pytest workers on one host the
    intra-op thread pools of each worker contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_scene_arrays(scene):
    """A JAX GpuScene's leaves {path: np.ndarray} and static fields."""
    import jax
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    arrays = {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
              for p, v in leaves}
    statics = {}
    for obj, prefix in ((scene, ""), (scene.mesh, "mesh.")):
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            if not f.metadata.get("pytree_node", True):
                statics[prefix + f.name] = getattr(obj, f.name)
    return arrays, statics


def port_scene_from_jax(scene):
    from rtf_tpu_torch.scene.convert import scene_from_arrays
    arrays, statics = jax_scene_arrays(scene)
    return scene_from_arrays(arrays, statics, device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "rtf_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "rtf_tpu"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_entry_points_default_to_the_card(tmp_path):
    from rtf_tpu_torch.cli import main
    from rtf_tpu_torch.gi.irradiance_cache import (
        build_irradiance_cache, render_with_cache)
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import preview, render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    desc = box_scene(8, 6, mesh_subdiv=0)
    if torch.cuda.is_available():
        assert build_scene(desc).cam_m.device.type == "cuda"
        return
    from test_torch_cli import write_cli_scene
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scene(desc)
    scene = build_scene(desc, device="cpu")
    cfg = RenderConfig(min_samples=1, max_samples=1, bounces=0,
                       gi_mode="hemisphere", hemisphere_samples=1)
    for fn in (lambda: render(scene), lambda: preview(scene),
               lambda: build_irradiance_cache(scene, cfg),
               lambda: render_with_cache(scene, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    # the CLI's --device defaults to the card: every subcommand that
    # touches a tensor raises without a card
    xml = write_cli_scene(tmp_path)
    for argv in (["render", xml], ["preview", xml], ["probe", xml,
                                                     "--pixel", "1,1"],
                 ["watch", xml, "--out", str(tmp_path / "w.png")],
                 ["photons", xml, "--count", "10"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    np.savez(tmp_path / "s.npz", num_px=32 * 24, width=32, height=24)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["view", xml, str(tmp_path / "s.npz")])


@pytest.mark.parametrize("case", ["caustic_wavefront"])
def test_unsupported_scenes_raise(case):
    """What neither path of the port renders.  The cases this test had
    before the wavefront was ported (the 'both' split, DOF, more than 2
    lights, more than 16 materials, emission texture maps) render now
    (test_torch_wavefront_render.py::test_formerly_refused_scenes_render),
    and so do its large-mesh cases since the MXU variant was ported
    (test_large_mesh_scenes_render), its photon cases since the photon
    pass was ported (test_torch_photon_render.py::
    test_formerly_refused_photon_scenes_render) and its tex_filter and bvh
    cases since footprint filtering and the BVH walk were ported
    (test_torch_wavefront_render.py::test_formerly_refused_filter_scenes_
    render).  A caustic volume on the wavefront stays refused: rtf_tpu's
    wavefront gathers caustics only from a photon grid."""
    from rtf_tpu_torch.gi.volume import load_volume
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    from test_torch_gi_volume import VOLUME
    desc = box_scene(8, 6, mesh_subdiv=0)
    cfg = RenderConfig(min_samples=8, max_samples=8, bounces=0,
                       shadow_min=1, shadow_max=1, split_mode="both")
    scene = build_scene(desc, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="caustic volume on the wavefront"):
        render(scene, cfg, device="cpu",
               caustic_vol=load_volume(VOLUME, device="cpu"))


@pytest.mark.parametrize("case", ["faces", "faces_rr_gi"])
def test_large_mesh_scenes_render(case):
    """A mesh over 512 faces on the 'rr' split, without and with
    hemisphere GI (the two scenes the port refused before its MXU variant):
    the fused path, the wave's MXU tables, a finite frame that is not
    black on the CPU."""
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path, scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(8, 6, mesh_subdiv=3), device="cpu")
    cfg = RenderConfig(min_samples=8, max_samples=8, bounces=0,
                       shadow_min=1, shadow_max=1)
    if case == "faces_rr_gi":
        cfg = cfg.with_(gi_mode="hemisphere", hemisphere_samples=2)
    assert scene.mesh.tri_a.shape[0] == 1280
    assert render_path(scene, cfg) == ("fused", None)
    tables = scene_tables(scene)
    assert tables.mxu
    res = render(scene, cfg, device="cpu", tables=tables)
    assert np.isfinite(res.radiance).all()
    assert res.image.shape == (6, 8, 3) and res.image.mean() > 5.0


def test_textured_scene_renders_on_cpu():
    """File textures on kd, an environment map and a background map: the
    scene renders (no longer refused), finite and not black, and the
    background map shows where no sample hit (the back wall is taken out,
    so primary rays and the mirror's reflections leave the box)."""
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    desc = textured_desc(16, 12, mesh_subdiv=0, background=True)
    box = desc.root.children[0]
    box.children = [n for n in box.children if n.name != "back"]
    scene = build_scene(desc, device="cpu")
    assert scene.has_file_tex and scene.env_tm >= 0 and scene.bg_tm >= 0
    res = render(scene, RenderConfig(min_samples=4, max_samples=4, bounces=2,
                                     shadow_min=1, shadow_max=1,
                                     split_mode="rr",
                                     env_on_reflect_miss=True), device="cpu")
    assert np.isfinite(res.radiance).all()
    assert res.image.shape == (12, 16, 3) and res.image.mean() > 5.0
    miss = res.z >= 1e29
    assert miss.any() and res.radiance[miss].std() > 0.01
