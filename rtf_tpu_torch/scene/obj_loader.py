"""Wavefront OBJ/MTL parser.

Semantics of cyTriMesh::LoadFromFileObj (cyTriMesh.h:263+): v/vt/vn/f with
polygon fan triangulation, v/vt/vn index triplets, mtllib/usemtl material
grouping, and the Mtl record (Kd/Ks/Tf/Ns/Ni/illum/map_Kd/map_Ks,
cyTriMesh.h:74-103).  Pure host-side NumPy; emits the port's MeshDesc.
A copy of rtf_tpu/scene/obj_loader.py.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from rtf_tpu_torch.scene.model import (
    MaterialDesc, MeshDesc, TexturedColorDesc)


class ObjMtl:
    """Raw MTL record (cyTriMesh::Mtl)."""

    def __init__(self, name: str):
        self.name = name
        self.Ka = np.zeros(3)
        self.Kd = np.full(3, 0.8)
        self.Ks = np.zeros(3)
        self.Tf = np.zeros(3)
        self.Ns = 0.0
        self.Ni = 1.0
        self.illum = 2
        self.map_Kd: Optional[str] = None
        self.map_Ks: Optional[str] = None


def _parse_vec(parts: List[str], n: int) -> np.ndarray:
    vals = [float(x) for x in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return np.array(vals, np.float32)


def load_mtl(path: str) -> List[ObjMtl]:
    mtls: List[ObjMtl] = []
    cur: Optional[ObjMtl] = None
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = ObjMtl(" ".join(parts[1:]))
                mtls.append(cur)
            elif cur is None:
                continue
            elif key == "Ka":
                cur.Ka = _parse_vec(parts[1:], 3)
            elif key == "Kd":
                cur.Kd = _parse_vec(parts[1:], 3)
            elif key == "Ks":
                cur.Ks = _parse_vec(parts[1:], 3)
            elif key == "Tf":
                cur.Tf = _parse_vec(parts[1:], 3)
            elif key == "Ns":
                cur.Ns = float(parts[1])
            elif key == "Ni":
                cur.Ni = float(parts[1])
            elif key == "illum":
                cur.illum = int(float(parts[1]))
            elif key == "map_Kd":
                cur.map_Kd = parts[-1]
            elif key == "map_Ks":
                cur.map_Ks = parts[-1]
    return mtls


def _idx(token: str, count: int) -> int:
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path: str, load_mtl_file: bool = True) -> MeshDesc:
    """Parse an OBJ file into a MeshDesc.

    `load_mtl_file=False` matches the reference's behaviour when the scene
    node already names a material (xmlload.cpp:205 `tobj->Load(name,
    mtlName==NULL)`).
    """
    vs: List[np.ndarray] = []
    vts: List[np.ndarray] = []
    vns: List[np.ndarray] = []
    faces: List[tuple] = []     # (v3, vt3, vn3, mtl_id)
    mtl_names: List[str] = []
    mtl_libs: List[str] = []
    cur_mtl = -1

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vs.append(_parse_vec(parts[1:], 3))
            elif key == "vt":
                vts.append(_parse_vec(parts[1:], 3))
            elif key == "vn":
                vns.append(_parse_vec(parts[1:], 3))
            elif key == "mtllib":
                mtl_libs.append(" ".join(parts[1:]))
            elif key == "usemtl":
                name = " ".join(parts[1:])
                if name not in mtl_names:
                    mtl_names.append(name)
                cur_mtl = mtl_names.index(name)
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = _idx(sub[0], len(vs))
                    ti = _idx(sub[1], len(vts)) if len(sub) > 1 and sub[1] else -1
                    ni = _idx(sub[2], len(vns)) if len(sub) > 2 and sub[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri = (corners[0], corners[k], corners[k + 1])
                    faces.append((
                        [c[0] for c in tri],
                        [c[1] for c in tri],
                        [c[2] for c in tri],
                        max(cur_mtl, 0),
                    ))

    mesh = MeshDesc(name=os.path.basename(path))
    mesh.v = np.array(vs, np.float32) if vs else np.zeros((0, 3), np.float32)
    mesh.f = np.array([f[0] for f in faces], np.int32) if faces else np.zeros((0, 3), np.int32)
    mesh.face_mtl = np.array([f[3] for f in faces], np.int32) if faces else np.zeros(0, np.int32)

    if vts:
        mesh.vt = np.array(vts, np.float32)
        ft = np.array([f[1] for f in faces], np.int32)
        mesh.ft = np.where(ft >= 0, ft, 0).astype(np.int32)
    if vns:
        mesh.vn = np.array(vns, np.float32)
        fn = np.array([f[2] for f in faces], np.int32)
        if (fn >= 0).all():
            mesh.fn = fn
        else:
            mesh.vn = None  # incomplete normal refs -> recompute below
    if mesh.vn is None:
        mesh.compute_normals()

    # MTL -> sub-material descriptions, keyed by usemtl order.
    if load_mtl_file and mtl_libs and mtl_names:
        raw = []
        for lib in mtl_libs:
            libpath = os.path.join(os.path.dirname(path), lib)
            if os.path.exists(libpath):
                raw.extend(load_mtl(libpath))
        by_name = {m.name: m for m in raw}
        mesh.materials = [
            _mtl_to_material(by_name.get(n, ObjMtl(n)), os.path.dirname(path))
            for n in mtl_names
        ]
    return mesh


def _mtl_to_material(m: ObjMtl, basedir: str) -> MaterialDesc:
    """OBJ MTL -> Blinn, replicating the illum-model mapping in
    xmlload.cpp:211-241 (illum>2 -> reflection=Ks; illum>=6 -> refraction=1-Tf).
    Texture file loading happens later in the scene builder."""
    d = MaterialDesc(name=m.name)
    d.diffuse = TexturedColorDesc(np.asarray(m.Kd, np.float64))
    d.specular = TexturedColorDesc(np.asarray(m.Ks, np.float64))
    d.glossiness = float(m.Ns)
    d.ior = float(m.Ni)
    d._map_kd = os.path.join(basedir, m.map_Kd) if m.map_Kd else None
    d._map_ks = os.path.join(basedir, m.map_Ks) if m.map_Ks else None
    if 2 < m.illum <= 7:
        d.reflection = TexturedColorDesc(np.asarray(m.Ks, np.float64))
        if m.illum >= 6:
            d.refraction = TexturedColorDesc(1.0 - np.asarray(m.Tf, np.float64))
    return d
