# Frozen copy of rtf_tpu_torch/scene/build.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
# Changed: ensure_bvh left out (the fused path walks no BVH).
"""Scene builder: SceneDesc (host) -> Scene (torch tensors on one device).

The port of rtf_tpu/scene/build.py for the render path this package runs:
the node hierarchy is flattened into per-instance world<->local
transforms grouped by primitive type, materials become a table, and
meshes become per-face SoA plus the Morton-packed triangle table of
ops/pack.py and, for csrc/mesh_hit.cu, a box hierarchy over each slot's
packed columns (ops/mesh_hit.py::MeshTree).  The per-slot BVH that
mesh_algo="bvh" walks (ops/bvh_hit.py) is built at the first trace that
asks for it (`ensure_bvh`), so no other path pays for it.
File textures are stacked into one row atlas, as rtf_tpu/scene/build.py does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from rtbench.reference.frozen.core.transform import Transform
from rtbench.reference.frozen.ops.mesh_hit import MeshTree, mesh_tree
from rtbench.reference.frozen.ops.pack import pack_triangles
from rtbench.reference.frozen.scene.model import (
    MaterialDesc, MeshDesc, NodeDesc, SceneDesc, TexturedColorDesc,
)

F32 = np.float32
I32 = np.int32

LIGHT_AMBIENT, LIGHT_DIRECT, LIGHT_POINT = 0, 1, 2
TEX_FILE, TEX_CHECKER = 0, 1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a host
    without it is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class InstanceGroup:
    """Instances of one primitive type. itm maps world->local, nrm = itm^T
    maps local normals -> world, tm = local->world."""
    itm: torch.Tensor        # [K,3,3]
    pos: torch.Tensor        # [K,3]
    nrm: torch.Tensor        # [K,3,3]
    mtl: torch.Tensor        # [K] int32 global material id
    mesh_slot: torch.Tensor  # [K] int32 (mesh group only; else zeros)
    tm: torch.Tensor         # [K,3,3]


@dataclass
class MeshArena:
    """All meshes concatenated, with the packed triangle table."""
    tri_a: torch.Tensor      # [F,3] vertex positions
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_na: torch.Tensor     # [F,3] vertex normals
    tri_nb: torch.Tensor
    tri_nc: torch.Tensor
    tri_ta: torch.Tensor     # [F,3] texture coords
    tri_tb: torch.Tensor
    tri_tc: torch.Tensor
    tri_mtl: torch.Tensor    # [F] int32 global material id
    tri_packed: torch.Tensor  # [40, sum F_pad] per-slot tables by columns
    tri_perm: torch.Tensor   # [sum F_pad] packed face id -> arena face id
    attr_n: torch.Tensor     # [F,16] vertex normals a/b/c, col 9 material
    attr_t: torch.Tensor     # [F,16] vertex uvw a/b/c, col 9 uv density
    tile_aabb: torch.Tensor  # [sum nt, 8]
    # per-slot (face_start, face_end) arena ranges
    slot_faces: tuple = ()
    # per-slot (col0, fpad, aabb_row0, nt, (mesh_lo, mesh_hi))
    slot_pack: tuple = ()
    # the box hierarchy that mesh_closest_hit's kernel walks
    hit_tree: Optional[MeshTree] = None
    # the BVH arena of mesh_algo="bvh" (rtf_tpu/scene/build.py:65-73):
    # None until `ensure_bvh` builds it, or carried across from rtf_tpu
    bvh_min: Optional[torch.Tensor] = None    # [N,3]
    bvh_max: Optional[torch.Tensor] = None
    bvh_child: Optional[torch.Tensor] = None  # [N] int32 first child
    # (arena-global), -1 = leaf
    bvh_eoff: Optional[torch.Tensor] = None   # [N] int32 offset into elems
    bvh_ecnt: Optional[torch.Tensor] = None   # [N] int32
    bvh_elems: Optional[torch.Tensor] = None  # [E] int32 arena face ids
    slot_root: Optional[torch.Tensor] = None  # [S] int32 root node per slot
    max_leaf: int = 8
    max_depth: int = 32
    # the kernel's packed copy of the BVH (ops/bvh_hit.py::BvhWalk)
    bvh_walk: Optional[object] = None


@dataclass
class MaterialTable:
    diffuse: torch.Tensor       # [M,3]
    diffuse_tm: torch.Tensor    # [M] texmap id or -1
    specular: torch.Tensor
    specular_tm: torch.Tensor
    emission: torch.Tensor
    emission_tm: torch.Tensor
    reflection: torch.Tensor
    reflection_tm: torch.Tensor
    refraction: torch.Tensor
    refraction_tm: torch.Tensor
    glossiness: torch.Tensor    # [M]
    refl_gloss: torch.Tensor
    refr_gloss: torch.Tensor
    ior: torch.Tensor
    absorption: torch.Tensor    # [M,3]


@dataclass
class LightTable:
    kind: torch.Tensor        # [L] int32
    intensity: torch.Tensor   # [L,3]
    direction: torch.Tensor   # [L,3]
    position: torch.Tensor    # [L,3]
    size: torch.Tensor        # [L] point-light radius (soft shadows)


@dataclass
class TextureTable:
    atlas: torch.Tensor  # [R, W, 3] float32; file textures stacked by rows
    kind: torch.Tensor   # [X] int32
    width: torch.Tensor  # [X] int32 (1 for checkers)
    height: torch.Tensor  # [X] int32 (1 for checkers)
    row0: torch.Tensor   # [X] int32 first atlas row
    c1: torch.Tensor     # [X,3] checker colors
    c2: torch.Tensor


@dataclass
class TexMapTable:
    tex: torch.Tensor   # [T] int32 texture id
    itm: torch.Tensor   # [T,3,3] uvw-space world->local
    pos: torch.Tensor   # [T,3]


@dataclass
class Scene:
    spheres: InstanceGroup
    planes: InstanceGroup
    mesh_inst: InstanceGroup
    mesh: Optional[MeshArena]
    materials: MaterialTable
    lights: LightTable
    textures: TextureTable
    texmaps: TexMapTable
    bg_color: torch.Tensor     # [3]
    env_color: torch.Tensor    # [3]
    cam_pos: torch.Tensor      # [3]
    cam_m: torch.Tensor        # [3,3] camera->world basis (columns x,up,z)
    bg_tm: int = -1
    env_tm: int = -1
    fov: float = 40.0
    focaldist: float = 1.0
    dof: float = 0.0
    width: int = 200
    height: int = 150
    num_spheres: int = 0
    num_planes: int = 0
    num_mesh_inst: int = 0
    num_lights: int = 0
    light_kinds: tuple = ()
    mesh_inst_slots: tuple = ()
    world_min: tuple = (-1.0,) * 3
    world_max: tuple = (1.0,) * 3
    # any file texture exists (the textured kernel variant is needed)
    has_file_tex: bool = False
    # the wavefront's statics (rtf_tpu/scene/build.py:165-196): some point
    # light has a size (soft shadows), some material is glossy, the
    # material channels with a texture map ("diffuse", "specular")
    any_soft_light: bool = False
    any_glossy: bool = False
    tm_channels: tuple = ()
    # mesh closest hit: 'auto' (ops/mesh_hit.py: the kernel on the card,
    # its plain version on the CPU; 'pallas' and 'pallas_interpret', the
    # names a scene built by rtf_tpu may carry, mean the same here)
    mesh_algo: str = "auto"
    # intersection era statics, set from the RenderConfig by `render`:
    # sphere epsilon (Proj3/4: 0), the reference-exact sphere quadratic
    # and hit-point shadow origins, the Proj3 min-root sphere rule
    isect_zero: float = 1e-3
    ref_exact: bool = False
    sphere_minroot: bool = False
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))


class _Builder:
    def __init__(self, desc: SceneDesc, device: torch.device):
        self.desc = desc
        self.device = device
        self.materials: List[MaterialDesc] = []
        self.mtl_index = {}
        self.texmaps = []       # (texture id, Transform)
        self.textures = []      # TextureDesc (unique by id)
        self.tex_index = {}
        self.groups = {"sphere": [], "plane": [], "mesh": []}
        self.meshes: List[dict] = []
        self.mesh_slot_cache = {}
        self.wmin = np.full(3, np.inf)
        self.wmax = np.full(3, -np.inf)

    def t(self, x, dtype=F32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype), device=self.device)

    # ---- materials / textures

    def add_material(self, m: MaterialDesc) -> int:
        key = id(m)
        if key in self.mtl_index:
            return self.mtl_index[key]
        self.materials.append(m)
        self.mtl_index[key] = len(self.materials) - 1
        return self.mtl_index[key]

    def add_texmap(self, tc: TexturedColorDesc) -> int:
        if tc is None or tc.texmap is None or tc.texmap.texture is None:
            return -1
        tm = tc.texmap
        tid = self.add_texture(tm.texture)
        self.texmaps.append((tid, tm.transform))
        return len(self.texmaps) - 1

    def add_texture(self, tex) -> int:
        key = id(tex)
        if key in self.tex_index:
            return self.tex_index[key]
        self.textures.append(tex)
        self.tex_index[key] = len(self.textures) - 1
        return self.tex_index[key]

    # ---- node flattening

    def flatten(self):
        named = dict(self.desc.materials)
        default_mtl = MaterialDesc(name="__default__")

        def walk(node: NodeDesc, parent_t: Transform):
            world_t = parent_t.compose(node.transform)
            if node.obj_kind is not None:
                mtl = named.get(node.mtl_name, default_mtl) \
                    if node.mtl_name else default_mtl
                mtl_id = self.add_material(mtl)
                entry = {
                    "itm": world_t.inv.astype(F32),
                    "pos": world_t.pos.astype(F32),
                    "nrm": world_t.inv.T.astype(F32),
                    "tm": world_t.m.astype(F32),
                    "mtl": mtl_id,
                    "mesh_slot": 0,
                }
                if node.obj_kind == "mesh":
                    entry["mesh_slot"] = self.add_mesh(node, mtl_id)
                self.groups[node.obj_kind].append(entry)
                self._grow_bounds(node, world_t)
            for child in node.children:
                walk(child, world_t)

        for child in self.desc.root.children:
            walk(child, self.desc.root.transform)

    def _grow_bounds(self, node: NodeDesc, world_t: Transform):
        if node.obj_kind == "sphere":
            lo, hi = np.full(3, -1.0), np.full(3, 1.0)
        elif node.obj_kind == "plane":
            lo, hi = np.array([-1.0, -1.0, 0.0]), np.array([1.0, 1.0, 0.0])
        else:
            lo = node.mesh.v.min(axis=0)
            hi = node.mesh.v.max(axis=0)
        for i in range(8):
            c = np.where([(i >> b) & 1 for b in range(3)], hi, lo)
            w = world_t.transform_from(c)
            self.wmin = np.minimum(self.wmin, w)
            self.wmax = np.maximum(self.wmax, w)

    def add_mesh(self, node: NodeDesc, inst_mtl_id: int) -> int:
        mesh: MeshDesc = node.mesh
        # per-face global material ids: the node material wins when bound
        # (xmlload.cpp:205,211-241); identical geometry+material shares
        # one arena slot (objList.Find, xmlload.cpp:203-210)
        multi = bool(mesh.materials) and node.mtl_name is None
        key = (id(mesh), -1 if multi else inst_mtl_id)
        if key in self.mesh_slot_cache:
            return self.mesh_slot_cache[key]
        if multi:
            sub_ids = np.array([self.add_material(m)
                                for m in mesh.materials], I32)
            fmtl = sub_ids[np.clip(mesh.face_mtl, 0, len(sub_ids) - 1)]
        else:
            fmtl = np.full(mesh.num_faces, inst_mtl_id, I32)
        self.meshes.append({"mesh": mesh, "face_mtl": fmtl})
        self.mesh_slot_cache[key] = len(self.meshes) - 1
        return self.mesh_slot_cache[key]

    # ---- packing

    def pack_group(self, kind: str) -> InstanceGroup:
        g = self.groups[kind]
        if not g:
            return InstanceGroup(
                itm=self.t(np.zeros((0, 3, 3))), pos=self.t(np.zeros((0, 3))),
                nrm=self.t(np.zeros((0, 3, 3))), mtl=self.t([], I32),
                mesh_slot=self.t([], I32), tm=self.t(np.zeros((0, 3, 3))))
        return InstanceGroup(
            itm=self.t(np.stack([e["itm"] for e in g])),
            pos=self.t(np.stack([e["pos"] for e in g])),
            nrm=self.t(np.stack([e["nrm"] for e in g])),
            mtl=self.t([e["mtl"] for e in g], I32),
            mesh_slot=self.t([e["mesh_slot"] for e in g], I32),
            tm=self.t(np.stack([e["tm"] for e in g])),
        )

    def pack_meshes(self) -> Optional[MeshArena]:
        if not self.meshes:
            return None
        tri = {k: [] for k in ("a", "b", "c", "na", "nb", "nc",
                               "ta", "tb", "tc")}
        tri_mtl = []
        slot_faces = []
        face_base = 0
        for rec in self.meshes:
            m: MeshDesc = rec["mesh"]
            f = m.f
            tri["a"].append(m.v[f[:, 0]])
            tri["b"].append(m.v[f[:, 1]])
            tri["c"].append(m.v[f[:, 2]])
            fn = m.fn if m.fn is not None else f
            tri["na"].append(m.vn[fn[:, 0]])
            tri["nb"].append(m.vn[fn[:, 1]])
            tri["nc"].append(m.vn[fn[:, 2]])
            if m.vt is not None and m.ft is not None:
                for k, col in (("ta", 0), ("tb", 1), ("tc", 2)):
                    tri[k].append(m.vt[m.ft[:, col]])
            else:
                z = np.full((len(f), 3), 0.5, F32)
                for k in ("ta", "tb", "tc"):
                    tri[k].append(z)
            tri_mtl.append(rec["face_mtl"])
            slot_faces.append((face_base, face_base + len(f)))
            face_base += len(f)

        packed_parts, perm_parts, aabb_parts = [], [], []
        slot_pack = []
        col0 = 0
        arow0 = 0
        for s, (fb, _) in enumerate(slot_faces):
            p, perm, aabb, mb = pack_triangles(
                *(tri[k][s] for k in ("a", "b", "c", "na", "nb", "nc",
                                      "ta", "tb", "tc")), tri_mtl[s])
            packed_parts.append(p)
            perm_parts.append(perm + fb)   # packed id -> arena face id
            aabb_parts.append(aabb)
            slot_pack.append((col0, p.shape[1], arow0, aabb.shape[0], mb))
            col0 += p.shape[1]
            arow0 += aabb.shape[0]

        cat = {k: np.concatenate(v).astype(F32) for k, v in tri.items()}
        mt_ = np.concatenate(tri_mtl).astype(F32)
        attr_n = np.zeros((len(mt_), 16), F32)
        attr_n[:, 0:3] = cat["na"]
        attr_n[:, 3:6] = cat["nb"]
        attr_n[:, 6:9] = cat["nc"]
        attr_n[:, 9] = mt_
        attr_t = np.zeros((len(mt_), 16), F32)
        attr_t[:, 0:3] = cat["ta"]
        attr_t[:, 3:6] = cat["tb"]
        attr_t[:, 6:9] = cat["tc"]
        # col 9: per-face isotropic uv density sqrt(area_uv/area_local)
        area_w = 0.5 * np.linalg.norm(
            np.cross(cat["b"] - cat["a"], cat["c"] - cat["a"]), axis=1)
        t1 = (cat["tb"] - cat["ta"])[:, :2]
        t2 = (cat["tc"] - cat["ta"])[:, :2]
        area_uv = 0.5 * np.abs(t1[:, 0] * t2[:, 1] - t1[:, 1] * t2[:, 0])
        attr_t[:, 9] = np.sqrt(area_uv / np.maximum(area_w, 1e-20))

        packed = np.concatenate(packed_parts, axis=1)
        return MeshArena(
            **{"tri_" + k: self.t(v) for k, v in cat.items()},
            tri_mtl=self.t(np.concatenate(tri_mtl), I32),
            tri_packed=self.t(packed),
            tri_perm=self.t(np.concatenate(perm_parts), I32),
            attr_n=self.t(attr_n), attr_t=self.t(attr_t),
            tile_aabb=self.t(np.concatenate(aabb_parts, axis=0)),
            slot_faces=tuple(slot_faces), slot_pack=tuple(slot_pack),
            hit_tree=mesh_tree(packed, slot_pack, slot_faces, self.device),
        )

    def pack_materials(self) -> MaterialTable:
        ms = self.materials or [MaterialDesc(name="__default__")]

        def chan(get_tc):
            cols = np.stack([np.asarray(get_tc(m).color, F32) for m in ms])
            tms = np.array([self.add_texmap(get_tc(m)) for m in ms], I32)
            return self.t(cols), self.t(tms, I32)

        dif, dif_tm = chan(lambda m: m.diffuse)
        spec, spec_tm = chan(lambda m: m.specular)
        emi, emi_tm = chan(lambda m: m.emission)
        refl, refl_tm = chan(lambda m: m.reflection)
        refr, refr_tm = chan(lambda m: m.refraction)
        return MaterialTable(
            diffuse=dif, diffuse_tm=dif_tm,
            specular=spec, specular_tm=spec_tm,
            emission=emi, emission_tm=emi_tm,
            reflection=refl, reflection_tm=refl_tm,
            refraction=refr, refraction_tm=refr_tm,
            glossiness=self.t([m.glossiness for m in ms]),
            refl_gloss=self.t([m.reflection_glossiness for m in ms]),
            refr_gloss=self.t([m.refraction_glossiness for m in ms]),
            ior=self.t([m.ior for m in ms]),
            absorption=self.t(np.stack([np.asarray(m.absorption, F32)
                                        for m in ms])),
        )

    def pack_lights(self) -> LightTable:
        ls = self.desc.lights
        kind_map = {"ambient": LIGHT_AMBIENT, "direct": LIGHT_DIRECT,
                    "point": LIGHT_POINT}

        def rows(get):
            return self.t(np.stack([np.asarray(get(l), F32) for l in ls])
                          if ls else np.zeros((0, 3), F32))
        return LightTable(
            kind=self.t([kind_map[l.kind] for l in ls], I32),
            intensity=rows(lambda l: l.intensity),
            direction=rows(lambda l: l.direction),
            position=rows(lambda l: l.position),
            size=self.t([l.size for l in ls]),
        )

    def pack_textures(self):
        """Checker textures as colour pairs; file textures stacked into one
        row atlas [sum of heights, max width, 3] with per-texture width,
        height and first row (rtf_tpu/scene/build.py::pack_textures)."""
        n = max(len(self.textures), 1)
        kinds = np.zeros(n, I32)
        widths = np.ones(n, I32)
        heights = np.ones(n, I32)
        row0 = np.zeros(n, I32)
        c1 = np.zeros((n, 3), F32)
        c2 = np.zeros((n, 3), F32)
        slices = []
        rows, maxw = 0, 1
        for i, t in enumerate(self.textures):
            if t.kind == "file" and t.data is not None:
                kinds[i] = TEX_FILE
                h, w = t.data.shape[:2]
                widths[i], heights[i], row0[i] = w, h, rows
                rows += h
                maxw = max(maxw, w)
                slices.append(t.data)
            else:
                kinds[i] = TEX_CHECKER
                c1[i] = np.asarray(t.color1, F32)
                c2[i] = np.asarray(t.color2, F32)
        atlas = np.zeros((max(rows, 1), maxw, 3), F32)
        r = 0
        for img in slices:
            h, w = img.shape[:2]
            atlas[r:r + h, :w] = img
            r += h
        tex_table = TextureTable(
            atlas=self.t(atlas), kind=self.t(kinds, I32),
            width=self.t(widths, I32), height=self.t(heights, I32),
            row0=self.t(row0, I32), c1=self.t(c1), c2=self.t(c2))
        if not self.texmaps:
            tmap = TexMapTable(tex=self.t([0], I32),
                               itm=self.t(np.eye(3)[None]),
                               pos=self.t(np.zeros((1, 3))))
        else:
            tmap = TexMapTable(
                tex=self.t([t for t, _ in self.texmaps], I32),
                itm=self.t(np.stack([tr.inv for _, tr in self.texmaps])),
                pos=self.t(np.stack([tr.pos for _, tr in self.texmaps])),
            )
        return tex_table, tmap


def camera_basis(cam) -> np.ndarray:
    """Camera->world basis with columns (x_new, up, z_new): the matrix the
    reference builds in RenderPixel (Final/main.cpp:219-224)."""
    z_new = -np.asarray(cam.dir, np.float64)
    x_new = np.cross(np.asarray(cam.up, np.float64), z_new)
    z_new /= np.linalg.norm(z_new)
    x_new /= np.linalg.norm(x_new)
    up = np.asarray(cam.up, np.float64)
    up = up / np.linalg.norm(up)
    return np.stack([x_new, up, z_new], axis=1).astype(F32)


def build_scene(desc: SceneDesc, device="cuda") -> Scene:
    dev = resolve_device(device)
    b = _Builder(desc, dev)
    b.flatten()
    materials = b.pack_materials()
    bg_tm = b.add_texmap(desc.background)
    env_tm = b.add_texmap(desc.environment)
    textures, texmaps = b.pack_textures()
    cam = desc.camera

    def bounds(v, fill):
        return tuple(float(x) for x in (v if np.isfinite(v).all()
                                        else np.full(3, fill)))
    return Scene(
        spheres=b.pack_group("sphere"),
        planes=b.pack_group("plane"),
        mesh_inst=b.pack_group("mesh"),
        mesh=b.pack_meshes(),
        materials=materials,
        lights=b.pack_lights(),
        textures=textures,
        texmaps=texmaps,
        bg_color=b.t(desc.background.color),
        env_color=b.t(desc.environment.color),
        cam_pos=b.t(cam.pos),
        cam_m=b.t(camera_basis(cam)),
        bg_tm=bg_tm, env_tm=env_tm,
        fov=float(cam.fov), focaldist=float(cam.focaldist),
        dof=float(cam.dof),
        width=int(cam.width), height=int(cam.height),
        num_spheres=len(b.groups["sphere"]),
        num_planes=len(b.groups["plane"]),
        num_mesh_inst=len(b.groups["mesh"]),
        num_lights=len(desc.lights),
        light_kinds=tuple(l.kind for l in desc.lights),
        mesh_inst_slots=tuple(int(e["mesh_slot"])
                              for e in b.groups["mesh"]),
        world_min=bounds(b.wmin, -1.0),
        world_max=bounds(b.wmax, 1.0),
        has_file_tex=any(t.kind == "file" and t.data is not None
                         for t in b.textures),
        any_soft_light=any(l.kind == "point" and l.size > 0
                           for l in desc.lights),
        any_glossy=bool(float(materials.refl_gloss.max()) > 0
                        or float(materials.refr_gloss.max()) > 0),
        tm_channels=tuple(
            ch for ch, tm in (("diffuse", materials.diffuse_tm),
                              ("specular", materials.specular_tm))
            if int(tm.max()) >= 0),
        device=dev,
    )
