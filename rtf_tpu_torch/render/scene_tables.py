"""The scene as flat float32 tables that the wave kernel reads.

Replaces rtf_tpu/render/fused.py::scene_consts, which bakes the scene into
TPU kernel immediates (fused.py:14-27), and the texture tables that
rtf_tpu's segmented path gathers from in XLA between its two kernels
(fused_seg.py:265-390).  Here the scene stays data: a few small row tables
in device memory, shared by the CUDA kernel and by the plain PyTorch wave
(render/wave.py, ops/texture.py), so both read exactly the same numbers.

Where the textures live: the port's `Scene` keeps rtf_tpu's structured
TextureTable/TexMapTable (atlas included), and `WaveTables` carries their
flat copies below, with the environment and background map ids.  The
kernel, the plain wave and finalize's background all sample the flat
copies.

Row layouts (float32; integer fields are stored as exact floats):

  instances [K, 24]  0-8 itm (world->local, row-major), 9-11 pos,
                     12-20 nrm (local->world normals, row-major), 21 mtl;
                     mesh instances: 22 first tile, 23 tile count
  roots     [I, 8]   per mesh instance its slot's root box, 0-2 lo, 3-5 hi
                     (padded), 6 the slot's first group, 7 its group count
  faces     [T * 128, 40]  per 128-face tile; the immediates: the packed
                     per-face rows of ops/pack.py, Morton order, padding
                     and degenerate columns dropped, each slot padded with
                     zero rows (which never hit) to whole tiles; on the MXU
                     tables [T * 128, 24], the pair test's columns of
                     ops/mxu_pack.py's face rows: 0-17 the Plücker rows,
                     18-20 n, 21 n.a, 22-23 zero
  shade     [T * 128, 16]  on the MXU tables the rest of those face rows,
                     read once per winner: 0 nc, 3 na - nc, 6 nb - nc, 9
                     material, 10 uv_c, 12 uv_a - uv_c, 14 uv_b - uv_c; [0,
                     16] on the immediates.  Split so that the faces a walk
                     tests take 96 bytes each instead of 160, and more of
                     them stay in the card's L2 cache
  groups    [G, 24]  ops/mxu_pack.py's groups of 8 tiles: 0-5 the padded
                     box, 6 first tile, 7 tile count, 8-15 the slot's group
                     visit orders, 16-23 the packed orders of the group's
                     tiles
  tnodes    [T, 24]  per tile: 0-5 the padded box, 6 first face row, 7 face
                     count, 8-15 its key base in each octant (on the MXU
                     tables its rank in the octant's visit order, on the
                     immediates its own index: a face's key is then its
                     packed row), 16-23 the packed orders of its leaves
  leaves    [T*8, 8] 16-face leaves: 0-5 the padded box, 6 first face row,
                     7 face count
  materials [M, 24]  0-2 kd, 3-5 ks, 6 gloss, 7-9 refl, 10-12 refr, 13 ior,
                     14-16 absorb, 17-19 emission, 20 refl gloss,
                     21 refr gloss, 22/23 kd/ks texmap id (-1: none)
  lights    [L, 16]  0 kind (0 ambient, 1 direct, 2 point), 1-3 intensity,
                     4-6 direction, 7-9 position, 10 size
  texmaps   [Q, 10]  0-2 itm row 0, 3-5 itm row 1, 6-8 pos, 9 texture id
  textures  [X, 10]  0 kind (0 file, 1 checker), 1 width, 2 height,
                     3 first atlas row, 4-6 checker c1, 7-9 checker c2
  atlas     [R*W, 4] the texels of the [R, W, 3] row atlas, row-major, each
                     padded to 4 floats (one 16-byte load in the kernel)

Meshes of up to MAX_FACES faces take the packed rows of ops/pack.py (the
TPU kernel's immediates); a larger mesh takes rtf_tpu's MXU tables
(fused.py::scene_mesh_mode, `mxu` below), and the wave kernel its MXU
variant.  rtf_tpu streams tables over 24 MiB from HBM tile by tile only
because of VMEM (fused.py:1627-1633); here one table in device memory
serves every size up to MXU_STREAM_MAX_FACES.

Checker and file textures take the same path: a material's kd/ks texmap
id picks a texmaps row, whose texture row says which sampler runs.

The root, group, tile and leaf boxes (ops/mxu_pack.py::walk_tables builds
them for both tables) are padded by 1e-4 * (1 + the largest
|coordinate| of the box): the triangle vertices lie on the box faces, so a
slab entry rounded a hair past a triangle's own t must not cull it, and a
face at exactly the lane's best t keeps a slab entry below that t.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from rtf_tpu_torch import _build
from rtf_tpu_torch.gi.volume import IrradianceVolume
from rtf_tpu_torch.ops.mxu_pack import (  # noqa: F401 (TILE_PAD)
    MXU_TILE, NODE_W, TILE_PAD, mesh_mxu_pack, packed_hierarchy,
    walk_tables)
from rtf_tpu_torch.scene.build import (
    LIGHT_AMBIENT, LIGHT_DIRECT, LIGHT_POINT, Scene,
)

MAX_FACES = 512        # immediates budget; above it the MXU tables
                       # (fused.py:55, scene_mesh_mode)
MXU_STREAM_MAX_FACES = 1 << 20  # rtf_tpu's fused gate (fused.py:61)
MAX_MATERIALS = 16
MAX_LIGHTS = 2         # non-ambient lights (shadow casters)
INST_W, FACE_W, MAT_W, LIGHT_W = 24, 40, 24, 16
PAIR_W, SHADE_W = 24, 16   # the MXU face rows' pair and shade columns
TEXMAP_W, TEX_W = 10, 10

_KIND = {"ambient": LIGHT_AMBIENT, "direct": LIGHT_DIRECT,
         "point": LIGHT_POINT}


GI_MODES = ("none", "hemisphere", "pathtrace", "photon")
WAVEFRONT_GI_MODES = GI_MODES + ("pm_direct",)


def fused_reason(scene: Scene, cfg, caustic=None):
    """None if rtf_tpu's fused kernel renders the scene+config on a TPU,
    else why not: the gates of rtf_tpu/render/fused.py::fuse_reason and
    fused_seg.py::seg_reason, in their order (the kernel's textured
    variant is the segmented path's), then renderer.py's caustic rule: a
    caustic map (grid or volume) goes to the fused path only as a volume,
    which rtf_tpu builds only with photon_volume.  The port's wave kernel
    (render/wave.py) takes all of these, a mesh over MAX_FACES faces on
    its MXU variant."""
    if cfg.gi_mode == "photon" and not cfg.photon_volume:
        return "gi_mode=photon without photon_volume (exact kNN is XLA)"
    if cfg.gi_mode not in GI_MODES:
        return f"gi_mode={cfg.gi_mode!r} not kernelized"
    if cfg.resolved_split_mode() != "rr":
        return "split_mode='both' (exact Fresnel split is XLA-only)"
    if cfg.tex_filter:
        return "tex_filter (ray-differential filtering is XLA-only)"
    mt = scene.materials
    for tm in (mt.emission_tm, mt.reflection_tm, mt.refraction_tm):
        if int(tm.max()) >= 0:
            return "emission/reflection/refraction texture maps"
    if sum(1 for k in scene.light_kinds if k != "ambient") > MAX_LIGHTS:
        return f"more than {MAX_LIGHTS} non-ambient lights"
    nf = _num_faces(scene)
    if nf > MXU_STREAM_MAX_FACES:
        return f"mesh has {nf} faces > streaming budget {MXU_STREAM_MAX_FACES}"
    nm = mt.diffuse.shape[0]
    if nm > MAX_MATERIALS:
        return f"{nm} materials > {MAX_MATERIALS}"
    if caustic is not None and not cfg.photon_volume:
        return "caustic grid present but no caustic volume built"
    return None


def _num_faces(scene: Scene) -> int:
    return 0 if scene.mesh is None else scene.mesh.tri_a.shape[0]


def wavefront_reason(scene: Scene, cfg, caustic=None):
    """None if the XLA wavefront's port (render/integrator.py) renders the
    scene+config, else why not."""
    if cfg.gi_mode not in WAVEFRONT_GI_MODES:
        return f"gi_mode={cfg.gi_mode!r} is not a mode of rtf_tpu"
    if isinstance(caustic, IrradianceVolume):
        return ("a caustic volume on the wavefront (its caustic term is "
                "the exact photon gather from a caustic grid, as in "
                "rtf_tpu)")
    return None


def mesh_mode(scene: Scene) -> str:
    """fused.py::scene_mesh_mode: 'none' without mesh instances, 'imm' up
    to MAX_FACES faces, 'mxu' above."""
    if scene.mesh is None or scene.num_mesh_inst == 0:
        return "none"
    return "imm" if _num_faces(scene) <= MAX_FACES else "mxu"


def render_path(scene: Scene, cfg, caustic=None):
    """The path rtf_tpu takes on a TPU (renderer.py:433-480) as (path,
    why): ('fused', None) where the wave kernel runs it (a mesh over
    MAX_FACES faces on its MXU variant), else ('wavefront', the fused
    path's reason), or (None, why neither runs it).  caustic: the caustic
    map handed to `render`, a PhotonGrid or an IrradianceVolume."""
    why = fused_reason(scene, cfg, caustic)
    if why is None:
        return "fused", None
    wf = wavefront_reason(scene, cfg, caustic)
    if wf is None:
        return "wavefront", why
    return None, f"fused: {why}; wavefront: {wf}"


@dataclass(frozen=True)
class WaveTables:
    """The wave kernel's tables (the layouts above) and the statics it is
    launched with.  Built by `scene_tables`; every table is checked where
    it is built (`__post_init__`, also on `dataclasses.replace`), and the
    tables cannot be swapped after."""
    spheres: torch.Tensor     # [S, 24]
    planes: torch.Tensor      # [P, 24]
    mesh_insts: torch.Tensor  # [I, 24]
    roots: torch.Tensor       # [I, 8]
    faces: torch.Tensor       # [T * 128, 40]; MXU: [T * 128, 24]
    groups: torch.Tensor      # [G, 24]
    tnodes: torch.Tensor      # [T, 24]
    leaves: torch.Tensor      # [T * 8, 8]
    shade: torch.Tensor       # MXU: [T * 128, 16], else [0, 16]
    materials: torch.Tensor   # [M, 24]
    lights: torch.Tensor      # [L, 16]
    texmaps: torch.Tensor     # [Q, 10]
    textures: torch.Tensor    # [X, 10]
    atlas: torch.Tensor       # [R*W, 4]
    atlas_w: int              # W, texels per atlas row
    env: tuple                # (r, g, b) floats
    env_tm: int               # environment texmap id, -1: plain colour
    bg_tm: int                # background texmap id, -1: plain colour
    has_file_tex: bool        # some texture is a file texture
    need_uv: bool             # some material has a kd/ks texture map
    has_gloss: bool           # some material has glossy refl/refr
    mxu: bool = False         # the mesh is on the MXU tables
    # on the MXU tables, per mesh instance its slot's unpadded root box
    # (lo3, hi3) as Python floats, what fused.py's scene_consts gives
    # _gi_mesh_perm
    mesh_bounds: tuple = ()

    def __post_init__(self):
        _build.check_tables("WaveTables", {
            f.name: getattr(self, f.name) for f in fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @property
    def textured(self) -> bool:
        """The wave needs the kernel's textured variant: file textures or
        an environment map."""
        return self.has_file_tex or self.env_tm >= 0

    @property
    def device(self) -> torch.device:
        return self.materials.device


def _instances(group, n, extra=None) -> np.ndarray:
    rows = np.zeros((n, INST_W), np.float32)
    if n:
        rows[:, 0:9] = group.itm.cpu().numpy().reshape(n, 9)
        rows[:, 9:12] = group.pos.cpu().numpy()
        rows[:, 12:21] = group.nrm.cpu().numpy().reshape(n, 9)
        rows[:, 21] = group.mtl.cpu().numpy()
    if extra is not None:
        rows[:, 22:24] = extra
    return rows


def _imm_pack(scene: Scene):
    """The immediates' faces and hierarchy: per slot its packed per-face
    rows in packed (Morton) order with padding and degenerate columns
    dropped (as scene_consts drops them), padded with zero rows to whole
    128-face tiles ([T * 128, 40]), and ops/mxu_pack.py's packed_hierarchy
    over their vertex boxes (rows 32-37)."""
    table = scene.mesh.tri_packed.cpu().numpy()
    faces, boxes = [], []
    for col0, fpad, _, _, _ in scene.mesh.slot_pack:
        cols = table[:, col0:col0 + fpad]
        keep = ~((cols[0] == 0) & (cols[1] == 0) & (cols[2] == 0))
        f = cols[:, keep].T
        nt = max(1, (f.shape[0] + MXU_TILE - 1) // MXU_TILE)
        faces.append(np.concatenate([f, np.zeros(
            (nt * MXU_TILE - f.shape[0], FACE_W), np.float32)]))
        boxes.append((f[:, 32:35], f[:, 35:38]))
    return np.concatenate(faces).astype(np.float32), packed_hierarchy(boxes)


def _mesh_tables(scene: Scene, mxu: bool):
    """faces, groups, tnodes, leaves, and per mesh instance its slot's tile
    range and root row; on the MXU tables also its slot's unpadded bounds,
    and faces [T * 128, 40] are the pair columns (PAIR_W) then the shade
    columns (SHADE_W)."""
    if scene.mesh is None or scene.num_mesh_inst == 0:
        return (np.zeros((0, FACE_W), np.float32),
                np.zeros((0, NODE_W), np.float32),
                np.zeros((0, NODE_W), np.float32),
                np.zeros((0, 8), np.float32), np.zeros((0, 2)),
                np.zeros((0, 8), np.float32), ())
    if mxu:
        pack = mesh_mxu_pack(scene.mesh)
        faces = pack["faces"]
        faces = np.concatenate([faces[:, 0:22], np.zeros(
            (faces.shape[0], PAIR_W - 22), np.float32), faces[:, 22:38]], 1)
    else:
        faces, pack = _imm_pack(scene)
    groups, tnodes, leaves, roots = walk_tables(pack)
    slots = [pack["slots"][s] for s in scene.mesh_inst_slots]
    ranges = np.asarray([s[:2] for s in slots], np.float32)
    bounds = tuple((s[2], s[3]) for s in slots) if mxu else ()
    return (faces, groups, tnodes, leaves, ranges,
            np.stack([roots[s] for s in scene.mesh_inst_slots]), bounds)


def _materials(scene: Scene) -> np.ndarray:
    mt = scene.materials
    m = mt.diffuse.shape[0]
    rows = np.zeros((m, MAT_W), np.float32)
    for col, x in ((0, mt.diffuse), (3, mt.specular), (6, mt.glossiness),
                   (7, mt.reflection), (10, mt.refraction), (13, mt.ior),
                   (14, mt.absorption), (17, mt.emission),
                   (20, mt.refl_gloss), (21, mt.refr_gloss)):
        x = x.cpu().numpy().reshape(m, -1)
        rows[:, col:col + x.shape[1]] = x
    rows[:, 22] = mt.diffuse_tm.cpu().numpy()
    rows[:, 23] = mt.specular_tm.cpu().numpy()
    return rows


def _texture_tables(scene: Scene):
    """texmaps [Q, 10], textures [X, 10], the padded atlas [R*W, 4] and W."""
    tm, tx = scene.texmaps, scene.textures
    itm = tm.itm.cpu().numpy()
    texmaps = np.zeros((itm.shape[0], TEXMAP_W), np.float32)
    texmaps[:, 0:3] = itm[:, 0]
    texmaps[:, 3:6] = itm[:, 1]
    texmaps[:, 6:9] = tm.pos.cpu().numpy()
    texmaps[:, 9] = tm.tex.cpu().numpy()
    kind = tx.kind.cpu().numpy()
    textures = np.zeros((kind.shape[0], TEX_W), np.float32)
    textures[:, 0] = kind
    textures[:, 1] = tx.width.cpu().numpy()
    textures[:, 2] = tx.height.cpu().numpy()
    textures[:, 3] = tx.row0.cpu().numpy()
    textures[:, 4:7] = tx.c1.cpu().numpy()
    textures[:, 7:10] = tx.c2.cpu().numpy()
    atlas = tx.atlas.cpu().numpy()
    texels = np.zeros((atlas.shape[0] * atlas.shape[1], 4), np.float32)
    texels[:, 0:3] = atlas.reshape(-1, 3)
    return texmaps, textures, texels, atlas.shape[1]


def _lights(scene: Scene) -> np.ndarray:
    lt = scene.lights
    rows = np.zeros((scene.num_lights, LIGHT_W), np.float32)
    if scene.num_lights:
        rows[:, 0] = [_KIND[k] for k in scene.light_kinds]
        rows[:, 1:4] = lt.intensity.cpu().numpy()
        rows[:, 4:7] = lt.direction.cpu().numpy()
        rows[:, 7:10] = lt.position.cpu().numpy()
        rows[:, 10] = lt.size.cpu().numpy()
    return rows


def scene_tables(scene: Scene, device=None) -> WaveTables:
    """Flatten a built scene into the wave kernel's tables on `device`
    (default: the scene's own device)."""
    dev = scene.device if device is None else torch.device(device)
    mxu = mesh_mode(scene) == "mxu"
    (faces, groups, tnodes, leaves, ranges, roots,
     bounds) = _mesh_tables(scene, mxu)
    mats = _materials(scene)
    texmaps, textures, atlas, atlas_w = _texture_tables(scene)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)
    return WaveTables(
        spheres=t(_instances(scene.spheres, scene.num_spheres)),
        planes=t(_instances(scene.planes, scene.num_planes)),
        mesh_insts=t(_instances(scene.mesh_inst, scene.num_mesh_inst,
                                ranges if len(ranges) else None)),
        roots=t(roots), faces=t(faces[:, 0:PAIR_W] if mxu else faces),
        groups=t(groups), tnodes=t(tnodes), leaves=t(leaves),
        shade=t(faces[:, PAIR_W:] if mxu else np.zeros((0, SHADE_W))),
        materials=t(mats),
        lights=t(_lights(scene)),
        texmaps=t(texmaps), textures=t(textures), atlas=t(atlas),
        atlas_w=int(atlas_w),
        env=tuple(float(x) for x in scene.env_color.tolist()),
        env_tm=int(scene.env_tm), bg_tm=int(scene.bg_tm),
        has_file_tex=bool(scene.has_file_tex),
        need_uv=bool(mats[:, 22:24].max(initial=-1.0) >= 0),
        has_gloss=bool(mats[:, 20:22].max(initial=0.0) > 0),
        mxu=mxu, mesh_bounds=bounds,
    )
