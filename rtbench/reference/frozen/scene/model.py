# Frozen copy of rtf_tpu_torch/scene/model.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Host-side scene description (pure Python / NumPy).

Mirrors the object model the reference's XML loader populates
(xmlload.cpp:65-554, scene.h Node/Camera/TexturedColor, materials.h
MtlBlinn, lights.h) but as plain dataclasses that the builder
(rtf_tpu_torch/scene/build.py) flattens into device tensors.  A copy of
rtf_tpu/scene/model.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from rtbench.reference.frozen.core.transform import Transform


@dataclass
class TextureDesc:
    kind: str                      # 'file' | 'checker'
    name: str = ""
    data: Optional[np.ndarray] = None   # float32 [H,W,3] in [0,1] for 'file'
    color1: np.ndarray = field(default_factory=lambda: np.zeros(3))
    color2: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class TexMapDesc:
    """Texture + its own uvw-space transform (scene.h:376-398 TextureMap)."""
    texture: Optional[TextureDesc]
    transform: Transform = field(default_factory=Transform)


@dataclass
class TexturedColorDesc:
    """Color x optional texture map (scene.h:406-434 TexturedColor)."""
    color: np.ndarray = field(default_factory=lambda: np.zeros(3))
    texmap: Optional[TexMapDesc] = None


@dataclass
class MaterialDesc:
    """Blinn material (materials.h:68-384 MtlBlinn)."""
    name: str = ""
    diffuse: TexturedColorDesc = field(default_factory=lambda: TexturedColorDesc(np.array([0.5, 0.5, 0.5])))
    specular: TexturedColorDesc = field(default_factory=lambda: TexturedColorDesc(np.array([0.7, 0.7, 0.7])))
    glossiness: float = 20.0
    emission: TexturedColorDesc = field(default_factory=lambda: TexturedColorDesc(np.zeros(3)))
    reflection: TexturedColorDesc = field(default_factory=lambda: TexturedColorDesc(np.zeros(3)))
    refraction: TexturedColorDesc = field(default_factory=lambda: TexturedColorDesc(np.zeros(3)))
    absorption: np.ndarray = field(default_factory=lambda: np.zeros(3))
    ior: float = 1.0
    reflection_glossiness: float = 0.0
    refraction_glossiness: float = 0.0


@dataclass
class LightDesc:
    kind: str                      # 'ambient' | 'direct' | 'point'
    name: str = ""
    intensity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    size: float = 0.0              # point light radius -> soft shadows


@dataclass
class MeshDesc:
    """Triangle mesh in SoA layout (cyTriMesh.h:52-202)."""
    name: str = ""
    v: np.ndarray = None           # [NV,3] float32
    f: np.ndarray = None           # [NF,3] int32 vertex indices
    vn: np.ndarray = None          # [NN,3] float32 vertex normals
    fn: np.ndarray = None          # [NF,3] int32 normal indices
    vt: np.ndarray = None          # [NT,3] float32 texcoords
    ft: np.ndarray = None          # [NF,3] int32 texcoord indices
    face_mtl: np.ndarray = None    # [NF] int32 local sub-material id (0 if none)
    materials: List[MaterialDesc] = field(default_factory=list)  # from MTL

    @property
    def num_faces(self) -> int:
        return 0 if self.f is None else len(self.f)

    def compute_normals(self):
        """Area-weighted vertex normals (cyTriMesh.h:248-261)."""
        vn = np.zeros_like(self.v)
        a, b, c = self.v[self.f[:, 0]], self.v[self.f[:, 1]], self.v[self.f[:, 2]]
        fnorm = np.cross(b - a, c - a)
        for k in range(3):
            np.add.at(vn, self.f[:, k], fnorm)
        lens = np.linalg.norm(vn, axis=1, keepdims=True)
        self.vn = np.where(lens > 0, vn / np.maximum(lens, 1e-30), vn).astype(np.float32)
        self.fn = self.f.copy()


@dataclass
class NodeDesc:
    """Scene-graph node (scene.h:438-514): transform + optional object +
    material name + children."""
    name: str = ""
    obj_kind: Optional[str] = None     # None | 'sphere' | 'plane' | 'mesh'
    mesh: Optional[MeshDesc] = None
    mtl_name: Optional[str] = None
    transform: Transform = field(default_factory=Transform)
    children: List["NodeDesc"] = field(default_factory=list)


@dataclass
class CameraDesc:
    """Pinhole + DOF camera (scene.h:518-536)."""
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    dir: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov: float = 40.0
    focaldist: float = 1.0
    dof: float = 0.0
    width: int = 200
    height: int = 150


@dataclass
class SceneDesc:
    root: NodeDesc = field(default_factory=NodeDesc)
    materials: Dict[str, MaterialDesc] = field(default_factory=dict)
    lights: List[LightDesc] = field(default_factory=list)
    background: TexturedColorDesc = field(default_factory=TexturedColorDesc)
    environment: TexturedColorDesc = field(default_factory=TexturedColorDesc)
    camera: CameraDesc = field(default_factory=CameraDesc)
