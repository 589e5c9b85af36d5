"""The port's boundary to its kernels (rtf_tpu_torch/_build.py), on the CPU.

The wave kernel's launch takes one struct, csrc/wave_kernel.cu's `Args`;
its Python mirror `_build.WaveArgs` must follow it field by field, in
order and in kind, or a launch reads one input as another.  The source is
parsed here, so drift shows without nvcc (on the card the library's
`rtf_wave_args_size` is held against the mirror's size as well:
tests/test_torch_kernel.py).  The tables a kernel reads in place are
checked once, by their constructor: WaveTables, MeshTree, BvhWalk and
FacePack refuse a table that is not float32, not contiguous, or not
16-byte aligned, also when rebuilt by `dataclasses.replace`."""
import ctypes
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from rtf_tpu_torch import _build

CU = Path(_build.ROOT) / "csrc" / "wave_kernel.cu"
# the C types of struct Args and the ctypes type that mirrors each
KINDS = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
         "uint32_t": ctypes.c_uint32, "float": ctypes.c_float}


def struct_fields(src: str, name: str):
    """[(field, C kind, array length or None)] of `struct name { ... };`,
    comments dropped; a pointer field's kind is "ptr"."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(.*?[\w*])\s+(\**\w+(?:\[\d+\])?"
                     r"(?:\s*,\s*\**\w+(?:\[\d+\])?)*)$", decl, re.S)
        ctype, names = m.group(1), m.group(2)
        for var in names.split(","):
            var = var.strip()
            ptr = ctype.endswith("*") or var.startswith("*")
            arr = re.match(r"\**(\w+)(?:\[(\d+)\])?$", var)
            kind = "ptr" if ptr else ctype.replace("const", "").strip()
            out.append((arr.group(1), kind,
                        int(arr.group(2)) if arr.group(2) else None))
    return out


def test_wave_args_mirror_follows_struct():
    """WaveArgs' fields are struct Args' fields, in order, each of its C
    type (pointers as c_void_p, float[3] as c_float * 3)."""
    c_fields = struct_fields(CU.read_text(), "Args")
    assert len(c_fields) == len(_build.WaveArgs._fields_) > 40
    for (name, kind, n), (pname, ptype) in zip(c_fields,
                                               _build.WaveArgs._fields_):
        assert pname == name
        assert ptype == (KINDS[kind] * n if n else KINDS[kind]), name


def test_wave_launch_takes_the_struct():
    """The launch's argtypes are the struct's pointer and the few inputs
    that are not its fields: no positional list of the struct's fields."""
    _, fn, argtypes = _build.KERNELS["wave"]
    assert fn == "rtf_wave_launch" and len(argtypes) == 5
    assert argtypes[0] == ctypes.POINTER(_build.WaveArgs)
    sig = re.search(r"int rtf_wave_launch\(([^)]*)\)", CU.read_text())
    assert sig.group(1).split(",")[0].strip() == "const void* args"
    assert "Args A = *static_cast<const Args*>(args);" in CU.read_text()
    assert "rtf_wave_args_size" in CU.read_text()


def test_pointer_and_stats_rules():
    """`pointer`: None and empty tensors are NULL.  `check_stats`: None
    passes; a stats tensor of another dtype, device or too short is
    refused."""
    x = torch.zeros(4)
    assert _build.pointer(None) == 0
    assert _build.pointer(torch.zeros(0, 8)) == 0
    assert _build.pointer(x) == x.data_ptr()
    cpu = torch.device("cpu")
    _build.check_stats("t", None, 4, cpu)
    _build.check_stats("t", torch.zeros(4, dtype=torch.int64), 4, cpu)
    for bad in (torch.zeros(4), torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="stats must be an int64"):
            _build.check_stats("t", bad, 4, cpu)


def _box(subdiv=1):
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    return build_scene(box_scene(32, 24, mesh_subdiv=subdiv), device="cpu")


def _wave_tables():
    from rtf_tpu_torch.render.scene_tables import scene_tables
    return scene_tables(_box())


def _mesh_tree():
    return _box().mesh.hit_tree


def _bvh_walk():
    from rtf_tpu_torch.ops.bvh_hit import build_walk
    from rtf_tpu_torch.scene.build import ensure_bvh
    return build_walk(ensure_bvh(_box().mesh), "wide")


def _face_pack():
    from rtf_tpu_torch.ops import mesh_hit_mxu as X
    from test_torch_common import icosphere_faces
    return X.pack_faces(torch.as_tensor(X.pack_tri_matrix(
        *icosphere_faces(1))))


# constructor: (a built object, the table to spoil)
BUILT = {"WaveTables": (_wave_tables, "faces"),
         "MeshTree": (_mesh_tree, "faces"),
         "BvhWalk": (_bvh_walk, "wnodes"),
         "FacePack": (_face_pack, "frags")}


def _spoil(x: torch.Tensor, fault: str) -> torch.Tensor:
    """x with its values and shape, but float64, strided, or at a 4-byte
    offset from a 16-byte boundary."""
    if fault == "float64":
        return x.double()
    if fault == "strided":
        y = torch.zeros((x.shape[0], 2 * x.shape[1]), dtype=x.dtype)
        y[:, ::2] = x
        return y[:, ::2]
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    return y


@pytest.mark.parametrize("fault", ["float64", "strided", "misaligned"])
@pytest.mark.parametrize("owner", list(BUILT))
def test_tables_checked_where_built(owner, fault):
    """Each table constructor refuses a spoiled table when it is built
    (here rebuilt by dataclasses.replace, which runs the check again),
    and takes the same values as a proper table."""
    make, name = BUILT[owner]
    obj = make()
    good = getattr(obj, name)
    assert good.numel() and type(obj).__name__ == owner
    bad = _spoil(good, fault)
    assert torch.allclose(bad.to(good.dtype), good, rtol=0, atol=0,
                          equal_nan=True)
    with pytest.raises(ValueError, match=f"{owner}: the {name} table"):
        dataclasses.replace(obj, **{name: bad})
    again = dataclasses.replace(obj, **{name: good.clone()})
    assert getattr(again, name).data_ptr() != good.data_ptr()


def test_wave_tables_are_frozen():
    """A built WaveTables cannot have a table swapped past the check; an
    int32 table where a float32 one is read is refused too."""
    tab = _wave_tables()
    with pytest.raises(dataclasses.FrozenInstanceError):
        tab.faces = tab.faces.clone()
    with pytest.raises(ValueError, match="WaveTables: the lights table"):
        dataclasses.replace(tab, lights=tab.lights.to(torch.int32))
