"""The port's host library (rtf_tpu_torch/native/: the C++ BVH builder and
PNG unfilter, built by _build.py::build_host at first use) on what
test_torch_bvh.py and test_torch_png.py do not reach.

The builder: many faces with one centre (no split separates them, so the
arbitrary halving), a flat mesh with zero extent on one axis, one face and
no faces, max_elems 1 and 255, a seeded 20,000-face soup, a tie between
the two axes tried after the widest; the port's C++ builder gives the six
arrays of its NumPy builder and of rtf_tpu's NumPy builder, values and
types, and those of rtf_tpu's native builder but where that one splits
otherwise than rtf_tpu's NumPy builder (NATIVE_SPLITS_OTHERWISE).  The
unfilter: odd widths at bpp 1, 2, 3, 4, 6 and 8 with a random filter byte
0-4 a row, native against unfilter_plain (and rtf_tpu's native unfilter),
and a filter byte past 4.
A missing compiler, a failing one and a library that does not load each
raise RuntimeError from build_bvh, read_png and load_scene: nothing falls
back to Python, and no scene comes back without its texture."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")


def _soup(seed, n):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-5.0, 5.0, (n, 1, 3))
    return (c + rng.normal(0.0, 0.4, (n, 3, 3))).astype(np.float32)


def _same_centre(n=40):
    """n triangles of different sizes and shapes whose boxes share one
    centre."""
    rng = np.random.RandomState(3)
    half = rng.uniform(0.1, 2.0, (n, 1, 3))
    tri = np.concatenate([-half, half, half * [[[1.0, -1.0, 0.5]]]], axis=1)
    return (tri + np.array([1.0, 2.0, 3.0])).astype(np.float32)


def _flat(k=12):
    """A k x k grid of triangle pairs in the plane z = 2."""
    g = np.stack(np.meshgrid(np.arange(k + 1), np.arange(k + 1),
                             indexing="ij"), -1).astype(np.float32)
    a, b, c, d = g[:-1, :-1], g[1:, :-1], g[1:, 1:], g[:-1, 1:]
    tri = np.concatenate([np.stack([a, b, c], 2), np.stack([a, c, d], 2)])
    tri = tri.reshape(-1, 3, 2)
    return np.concatenate([tri, np.full(tri.shape[:2] + (1,), 2.0,
                                        np.float32)], -1)


def _axis_tie(k=6):
    """Tall triangles (y in [-5, 5]) whose centres share y and lie on a k x
    k grid in x and z: the widest axis y cannot split them, and x and z
    tie for the next."""
    g = np.stack(np.meshgrid(np.arange(k), np.arange(k), indexing="ij"),
                 -1).reshape(-1, 2).astype(np.float32)
    c = np.stack([g[:, 0], np.zeros(k * k, np.float32), g[:, 1]], 1)
    off = np.array([[-0.25, -5.0, -0.25], [0.25, 5.0, 0.25],
                    [0.0, 0.0, 0.0]], np.float32)
    return c[:, None, :] + off


CASES = {
    "same centre": (_same_centre, 8),
    "flat": (_flat, 8),
    "axis tie": (_axis_tie, 4),
    "one face": (lambda: _soup(1, 1), 8),
    "no faces": (lambda: np.zeros((0, 3, 3), np.float32), 8),
    "max_elems 1": (lambda: _soup(2, 500), 1),
    "max_elems 255": (lambda: _soup(2, 3000), 255),
    "soup 20000": (lambda: _soup(5, 20000), 8),
}


# rtf_tpu's native builder takes the midpoint in double and, when the
# widest axis is y, tries z before x on a tie; its NumPy builder (the
# reference, as cy::BVH) and both of the port's builders do not, so the two
# rtf_tpu builders give other trees on these cases
NATIVE_SPLITS_OTHERWISE = {"same centre", "axis tie", "max_elems 1",
                           "soup 20000"}


@pytest.mark.parametrize("case", list(CASES))
def test_native_builder_matches_plain_and_jax(case):
    from rtf_tpu.native.binding import native_build_bvh as jnative
    from rtf_tpu.ops import bvh as J
    from rtf_tpu_torch.ops import bvh as P
    make, max_elems = CASES[case]
    tri = make()
    bmin, bmax = tri.min(1), tri.max(1)
    centers = (0.5 * (bmin + bmax)).astype(np.float64)
    got = P.build_bvh(centers, bmin, bmax, max_elems)
    refs = {"port NumPy": P.build_bvh(centers, bmin, bmax, max_elems,
                                      use_native=False),
            "rtf_tpu NumPy": J.build_bvh(centers, bmin, bmax, max_elems,
                                         use_native=False)}
    if len(tri):
        out = jnative(centers, bmin, bmax, max_elems)
        assert out is not None, "rtf_tpu's native library did not load"
        same = all(np.array_equal(a, b) for a, b in zip(
            out, refs["rtf_tpu NumPy"]))
        assert same == (case not in NATIVE_SPLITS_OTHERWISE)
        if same:
            refs["rtf_tpu native"] = out
    for ref_name, ref in refs.items():
        for name, a, b in zip(got._fields, got, ref):
            assert a.dtype == b.dtype, (ref_name, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{ref_name} {name}")
    leaf = got.child[1:] < 0
    assert np.array_equal(np.sort(got.elems), np.arange(len(tri)))
    assert got.elem_cnt[1:][leaf].sum() == len(tri)
    if case == "same centre":          # only the halving splits these
        assert leaf.sum() > 1 and got.elem_cnt[1:][leaf].max() <= 8
    if case == "max_elems 1":
        assert got.elem_cnt[1:][leaf].max() == 1
    nf = len(tri)
    mesh = P.build_mesh_bvh(tri.reshape(-1, 3),
                            np.arange(3 * nf).reshape(nf, 3), max_elems)
    for a, b in zip(mesh, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain(bpp):
    """Random scanlines of odd widths, each row's filter byte 0-4 at
    random: the host library's unfilter equals unfilter_plain and
    rtf_tpu's native unfilter byte for byte."""
    from rtf_tpu.native.binding import native_png_unfilter as jnative
    from rtf_tpu_torch.native.binding import native_png_unfilter
    from rtf_tpu_torch.utils.png import unfilter_plain
    rng = np.random.RandomState(bpp)
    for w in (1, 7, 33):
        h, stride = 11, w * bpp
        raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
        raw[:, 0] = rng.randint(0, 5, h)
        got = native_png_unfilter(raw, h, stride, bpp)
        assert got.dtype == np.uint8 and got.shape == (h, stride)
        np.testing.assert_array_equal(got, unfilter_plain(raw, h, stride,
                                                          bpp))
        np.testing.assert_array_equal(got, jnative(raw, h, stride, bpp))


def test_bad_filter_byte_raises():
    from rtf_tpu_torch.native.binding import native_png_unfilter
    from rtf_tpu_torch.utils.png import unfilter_plain
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    for fn in (native_png_unfilter, unfilter_plain):
        with pytest.raises(ValueError, match="bad filter 5"):
            fn(raw, 3, 6, 3)


XML = """<xml><scene>
<object type="plane" name="floor" material="wall"><scale value="8"/></object>
<material type="blinn" name="wall">
<diffuse value="1" texture="wall.png"/></material>
<light type="point" name="L"><intensity value="10"/>
<position x="0" y="0" z="5"/></light>
</scene><camera><position x="0" y="-10" z="3"/><target x="0" y="0" z="0"/>
<up x="0" y="0" z="1"/><fov value="40"/><width value="8"/>
<height value="6"/></camera></xml>
"""


def _textured_scene(directory):
    from rtf_tpu_torch.utils.png import write_png
    write_png(str(directory / "wall.png"), np.random.RandomState(0).randint(
        0, 256, (4, 5, 3)).astype(np.uint8))
    (directory / "scene.xml").write_text(XML)
    return directory / "scene.xml"


def _wall_texture(desc):
    tm = desc.materials["wall"].diffuse.texmap
    return None if tm is None or tm.texture is None else tm.texture.data


@pytest.mark.parametrize("fault", ["no compiler", "compiler fails",
                                   "does not load"])
def test_host_library_failure_raises(tmp_path, monkeypatch, fault):
    """With the host library not yet built into an empty build directory,
    a fault in its build or load raises RuntimeError from build_bvh,
    read_png and load_scene, whose texture loader drops a texture on an
    OSError or ValueError; with the library the scene has its texture."""
    import shutil

    from rtf_tpu_torch import _build
    from rtf_tpu_torch.ops.bvh import build_bvh
    from rtf_tpu_torch.scene.xml_loader import load_scene
    from rtf_tpu_torch.utils.png import read_png
    xml = _textured_scene(tmp_path)
    assert _wall_texture(load_scene(str(xml))).shape == (4, 5, 3)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.delenv("CXX", raising=False)
    if fault == "no compiler":
        monkeypatch.setattr(shutil, "which", lambda name: None)
        match = "no C\\+\\+ compiler found"
    elif fault == "compiler fails":
        cc = tmp_path / "cc.sh"
        cc.write_text("#!/bin/sh\necho 'cc: internal error' >&2\nexit 3\n")
        os.chmod(cc, 0o755)
        monkeypatch.setenv("CXX", str(cc))
        match = "failed \\(exit 3\\):\ncc: internal error"
    else:
        _build.BUILD_DIR.mkdir()
        _build.host_library_path().write_bytes(b"not a shared library")
        match = "cannot load the host library"
    tri = _soup(1, 20)
    bmin, bmax = tri.min(1), tri.max(1)
    with pytest.raises(RuntimeError, match=match):
        build_bvh((0.5 * (bmin + bmax)).astype(np.float64), bmin, bmax)
    with pytest.raises(RuntimeError, match=match):
        read_png(str(tmp_path / "wall.png"))
    with pytest.raises(RuntimeError, match=match):
        load_scene(str(xml))
    assert not list(_build.BUILD_DIR.glob("*.tmp.so")) \
        if _build.BUILD_DIR.exists() else True
