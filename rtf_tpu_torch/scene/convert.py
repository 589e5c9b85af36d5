"""Carry a scene built by the JAX package across into the port.

`scene_from_arrays` takes the leaves of an `rtf_tpu` GpuScene as plain
numpy arrays keyed by their tree path ("spheres.itm", "mesh.tri_packed",
"bg_color", ...) and its static fields by name ("width", "light_kinds",
"mesh.slot_pack", ...), and returns the port's `Scene`.  Nothing here
imports JAX: the caller flattens the GpuScene.  The BVH arena's leaves
(mesh.bvh_*, mesh.slot_root) come across with the rest, so the port's
walk can run on rtf_tpu's own tree; leaves the port has no field for are
ignored.  The mesh's box hierarchy for csrc/mesh_hit.cu
(MeshArena.hit_tree) is built here from the packed table.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtf_tpu_torch.ops.mesh_hit import mesh_tree
from rtf_tpu_torch.scene.build import (
    InstanceGroup, LightTable, MaterialTable, MeshArena, Scene, TexMapTable,
    TextureTable, resolve_device,
)

_TABLES = {
    "spheres": InstanceGroup, "planes": InstanceGroup,
    "mesh_inst": InstanceGroup, "mesh": MeshArena,
    "materials": MaterialTable, "lights": LightTable,
    "textures": TextureTable, "texmaps": TexMapTable,
}


def _is_tensor_field(f: dataclasses.Field) -> bool:
    return f.type in ("torch.Tensor", "Optional[torch.Tensor]")


def scene_from_arrays(arrays: dict, statics: dict, device="cuda") -> Scene:
    dev = resolve_device(device)

    def tensor(key):
        return torch.as_tensor(np.array(arrays[key]), device=dev)

    kw = {}
    for name, cls in _TABLES.items():
        if name == "mesh" and not any(k.startswith("mesh.") for k in arrays):
            kw[name] = None
            continue
        sub = {}
        for f in dataclasses.fields(cls):
            key = f"{name}.{f.name}"
            if _is_tensor_field(f):
                if key in arrays or not f.type.startswith("Optional"):
                    sub[f.name] = tensor(key)
            elif key in statics:
                sub[f.name] = statics[key]
        kw[name] = cls(**sub)
    if kw["mesh"] is not None:
        m = kw["mesh"]
        kw["mesh"] = dataclasses.replace(m, hit_tree=mesh_tree(
            m.tri_packed, m.slot_pack, m.slot_faces, dev))
    for f in dataclasses.fields(Scene):
        if f.name in kw or f.name == "device":
            continue
        if _is_tensor_field(f):
            kw[f.name] = tensor(f.name)
        elif f.name in statics:
            kw[f.name] = statics[f.name]
    return Scene(**kw, device=dev)

