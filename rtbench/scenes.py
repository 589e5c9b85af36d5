"""The benchmark's scene makers.  The built-in one, `box`, is a frozen copy
of rtf_tpu_torch/scene/procedural.py::box_scene (commit 224dbd1) with a
vectorised icosphere.

A maker builds the description from the classes it is handed (`Kinds`),
so the program (rtf_tpu_torch.scene.model) and the reference
(rtbench/reference/frozen/scene/model.py) each get a description of their
own from the same numbers, and a later edit of the port's procedural
module cannot change the benchmark's input.  `icosphere` gives
procedural.py::icosphere_mesh's vertices and faces exactly, in the same
order (rtbench/tests/test_rtbench_scenes.py), without its Python loop
over faces (4.7 s at subdivision 7).

A configuration file (rtbench/configs/<name>.json) names its maker under
"scene" and gives the maker's arguments under "args".  `box` is built in;
any other name is the function `make(k: Kinds, **args) -> SceneDesc` of
rtbench/makers/<scene>.py, loaded from its path, so a new scene is a new
file.  A maker takes `width` and `height` among its arguments (the
rehearsal and the tests override them), builds every description from
`k` and imports no model module itself; it may use this module's helpers
(`icosphere`, `icosphere_mesh`, `material`, `node`, `box`).  Its data
comes from the configuration file alone: texels and any other array are
drawn from a seed among the file's "args", never read from a file outside
the repo nor fetched.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import NamedTuple

import numpy as np

from rtbench import manifest


class Kinds(NamedTuple):
    """The description classes of one side (program or reference)."""
    Transform: type
    SceneDesc: type
    NodeDesc: type
    MaterialDesc: type
    MeshDesc: type
    LightDesc: type
    CameraDesc: type
    TexturedColorDesc: type
    TextureDesc: type
    TexMapDesc: type


def kinds_of(model, transform) -> Kinds:
    """Kinds from a side's scene/model.py and core/transform.py modules."""
    return Kinds(transform.Transform, *(getattr(model, k) for k in Kinds._fields[1:]))


def icosphere(subdiv: int):
    """Vertices [V, 3] float64 (unit length) and faces [F, 3] int64 of the
    subdivided icosahedron, as procedural.py::icosphere_mesh makes them:
    each pass splits every face (a, b, c) into (a, ab, ca), (b, bc, ab),
    (c, ca, bc), (ab, bc, ca), a new vertex per edge numbered in the order
    the faces first reach it, then renormalises every vertex."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        nv = len(v)
        # edges (a, b), (b, c), (c, a) of each face, in the loop's order
        ea = f.reshape(-1)
        eb = f[:, [1, 2, 0]].reshape(-1)
        key = np.minimum(ea, eb) * nv + np.maximum(ea, eb)
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        rank = np.empty(len(uniq), np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
        mid = nv + rank[inv.reshape(-1)]
        # a new vertex is the first edge's normalised sum, one row at a
        # time as np.linalg.norm takes a single vector
        p = v[ea[first]] + v[eb[first]]
        p = p / np.sqrt(np.einsum("ij,ij->i", p, p))[:, None]
        newv = np.empty((len(uniq), 3))
        newv[rank] = p
        v = np.concatenate([v, newv])
        ab, bc, ca = (mid.reshape(-1, 3)[:, k] for k in range(3))
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                      np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                     axis=1).reshape(-1, 3)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v, f


def material(k: Kinds, name, diffuse, specular=(0.7, 0.7, 0.7), gloss=20.0,
             reflection=(0, 0, 0), refraction=(0, 0, 0), ior=1.0,
             absorption=(0, 0, 0), emission=(0, 0, 0)):
    m = k.MaterialDesc(name=name)
    m.diffuse = k.TexturedColorDesc(np.array(diffuse, np.float64))
    m.specular = k.TexturedColorDesc(np.array(specular, np.float64))
    m.glossiness = gloss
    m.reflection = k.TexturedColorDesc(np.array(reflection, np.float64))
    m.refraction = k.TexturedColorDesc(np.array(refraction, np.float64))
    m.ior = ior
    m.absorption = np.array(absorption, np.float64)
    m.emission = k.TexturedColorDesc(np.array(emission, np.float64))
    return m


def node(k: Kinds, name, kind, mtl, transform, mesh=None):
    n = k.NodeDesc(name=name, obj_kind=kind, mtl_name=mtl, mesh=mesh)
    n.transform = transform
    return n


def icosphere_mesh(k: Kinds, subdiv: int):
    v, f = icosphere(subdiv)
    mesh = k.MeshDesc(name="icosphere")
    mesh.v = v.astype(np.float32)
    mesh.f = f.astype(np.int32)
    mesh.face_mtl = np.zeros(len(f), np.int32)
    mesh.compute_normals()
    return mesh


def box(k: Kinds, width: int = 200, height: int = 150,
        with_mesh: bool = True, light_size: float = 0.0, dof: float = 0.0,
        mesh_subdiv: int = 2):
    """procedural.py::box_scene: the Cornell-style box of the Proj13 scene,
    a mirror and a glass sphere, an icosphere ball and one point light."""
    T = k.Transform
    s = k.SceneDesc()
    walls = k.NodeDesc(name="box")
    walls.transform = T().translate([0, 0, 12])
    walls.children = [
        node(k, "floor", "plane", "wall", T().scale(32).translate([0, 0, -12])),
        node(k, "ceiling", "plane", "wall", T().scale(32).rotate([1, 0, 0], 180).translate([0, 0, 12])),
        node(k, "back", "plane", "wall", T().scale(32).rotate([1, 0, 0], 90).translate([0, 20, 0])),
        node(k, "left", "plane", "wallRed", T().scale(32).rotate([0, 1, 0], 90).translate([-15, 0, 0])),
        node(k, "right", "plane", "wallBlue", T().scale(32).rotate([0, 1, 0], -90).translate([15, 0, 0])),
    ]
    s.root.children.append(walls)
    s.root.children.append(
        node(k, "mirror", "sphere", "mirror", T().scale(4).translate([8, -6, 4])))
    s.root.children.append(
        node(k, "glass", "sphere", "glass", T().scale(4).translate([-8, -6, 4])))
    if with_mesh:
        s.root.children.append(
            node(k, "ball", "mesh", "redball",
                 T().scale(3).translate([1, 4, 3]),
                 mesh=icosphere_mesh(k, mesh_subdiv)))
    s.materials = {
        "wall": material(k, "wall", (1, 1, 1), specular=(0, 0, 0)),
        "wallRed": material(k, "wallRed", (1, 0.5, 0.5), specular=(0, 0, 0)),
        "wallBlue": material(k, "wallBlue", (0.5, 0.5, 1), specular=(0, 0, 0)),
        "mirror": material(k, "mirror", (0, 0, 0), specular=(1, 1, 1), gloss=80,
                           reflection=(1, 1, 1)),
        "glass": material(k, "glass", (0, 0, 0), specular=(1, 1, 1), gloss=80,
                          refraction=(1, 1, 1), ior=1.52),
        "redball": material(k, "redball", (1.0, 0.3, 0.3)),
    }
    s.lights = [k.LightDesc(kind="point", name="L",
                            intensity=np.full(3, 100.5),
                            position=np.array([0.0, 0.0, 22.0]),
                            size=light_size)]
    cam = k.CameraDesc()
    cam.pos = np.array([0.0, -60.0, 12.0])
    target = np.array([0.0, 0.0, 12.0])
    d = target - cam.pos
    cam.dir = d / np.linalg.norm(d)
    cam.up = np.array([0.0, 0.0, 1.0])
    x = np.cross(cam.dir, cam.up)
    up = np.cross(x, cam.dir)
    cam.up = up / np.linalg.norm(up)
    cam.fov = 30.0
    cam.width = width
    cam.height = height
    cam.dof = dof
    s.camera = cam
    return s


MAKERS = {"box": box}          # built in; any other scene is a file
SCENE_NAME = re.compile(r"[A-Za-z0-9_]+")


def maker(scene: str, bench_dir: Path = manifest.BENCH_DIR):
    """The function a configuration's "scene" names: a built-in maker, or
    `make` of rtbench/makers/<scene>.py.  Raises ValueError for a name that
    is not [A-Za-z0-9_]+, FileNotFoundError naming the path looked for where
    there is no file."""
    if scene in MAKERS:
        return MAKERS[scene]
    if not isinstance(scene, str) or not SCENE_NAME.fullmatch(scene):
        raise ValueError(f"scene {scene!r} is not a name of [A-Za-z0-9_]+")
    path = Path(bench_dir) / "makers" / f"{scene}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no maker {path} for scene {scene!r}")
    return manifest.load_module(path, f"rtbench_maker_{scene}").make


def make(config: dict, k: Kinds, width: int = None, height: int = None,
         bench_dir: Path = manifest.BENCH_DIR):
    """The description a configuration file names, built from `k`'s
    classes; width and height override the file's (the CPU rehearsal and
    the tests run tiny frames)."""
    args = dict(config["args"])
    if width is not None:
        args["width"], args["height"] = width, height
    desc = maker(config["scene"], bench_dir)(k, **args)
    if not isinstance(desc, k.SceneDesc):
        raise TypeError(f"scene {config['scene']!r} made a "
                        f"{type(desc).__module__}.{type(desc).__name__}, "
                        f"not the SceneDesc it was handed")
    return desc
