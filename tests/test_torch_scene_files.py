"""The port's scene-file loaders (rtf_tpu_torch/scene/xml_loader.py,
obj_loader.py, utils/png.py::read_png and the PPM reader) against
rtf_tpu's on a file set this file writes: an XML with comments (a nested
`<!--` opener too), a node hierarchy with scale/rotate/translate in
document order, planes and spheres, one OBJ named twice with a material
(one shared mesh slot), one OBJ without (its MTL's two sub-materials,
map_Kd a PNG, map_Ks a PPM, illum 3 and 7), a missing OBJ (a warning,
the node kept without geometry), value-scaled colours and vectors,
checker and file textures with their own transforms, a background map,
ambient, direct and point lights, a non-blinn material and an unknown
light type (both ignored), and a full camera.

`load_scene` must give the same description field for field (numbers
equal, meshes' arrays equal, textures' texels equal), and the two
packages' `build_scene` the same tables (test_torch_scene.py's rule:
floats within atol 1e-6, integers equal)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_torch_common import jax_scene_arrays  # noqa: E402
from test_torch_scene import scene_leaves  # noqa: E402

XML = """<xml>
<!-- a scene file <!-- with a nested opener -->
<scene>
  <background r="0.2" g="0.3" b="0.4" texture="sky.ppm">
    <scale value="0.5"/>
  </background>
  <environment value="0.8"/>
  <object name="box">
    <translate z="12"/>
    <object type="plane" name="floor" material="wall">
      <scale value="32"/> <translate z="-12"/>
    </object>
    <object type="plane" name="back" material="checks">
      <scale value="32"/> <rotate x="1" angle="90"/> <translate y="20"/>
    </object>
    <object name="group">
      <rotate z="1" angle="30"/> <scale x="2" y="1" z="1.5"/>
      <translate x="1" y="2"/>
      <object type="sphere" name="glass" material="glass">
        <scale value="3"/> <translate x="-6" y="-4" z="-6"/>
      </object>
      <object type="obj" name="cube.obj" material="wall">
        <translate x="4"/>
      </object>
    </object>
    <object type="obj" name="cube.obj" material="wall">
      <rotate y="1" angle="-40"/> <translate x="-5" z="3"/>
    </object>
  </object>
  <object type="obj" name="cube2.obj">
    <scale value="2"/> <translate x="6" y="5" z="4"/>
  </object>
  <object type="obj" name="missing.obj" material="wall"/>
  <material type="blinn" name="wall">
    <diffuse value="0.7" texture="wall.png"><scale value="0.25"/></diffuse>
    <specular r="0.2" g="0.2" b="0.2" value="0.5"/>
    <glossiness value="30"/>
  </material>
  <material type="blinn" name="checks">
    <diffuse texture="checkerboard">
      <color1 r="0.1" g="0.1" b="0.1"/> <color2 r="0.9" g="0.8" b="0.2"/>
      <scale value="0.125"/> <translate x="0.1"/>
    </diffuse>
    <reflection value="0.3" glossiness="0.05"/>
    <emission r="0.01"/>
  </material>
  <material type="blinn" name="glass">
    <diffuse value="0"/> <specular value="1"/>
    <refraction value="1" index="1.52" glossiness="0.02"/>
    <absorption r="0.000001" g="1" b="1"/>
  </material>
  <material type="phong" name="ignored"/>
  <light type="ambient" name="amb"><intensity value="0.1"/></light>
  <light type="direct" name="sun">
    <intensity r="0.3" g="0.3" b="0.2"/> <direction x="1" y="2" z="-3"/>
  </light>
  <light type="point" name="lamp">
    <intensity value="60"/> <position x="-5" z="22"/> <size value="1.5"/>
  </light>
  <light type="area" name="ignored"/>
</scene>
<camera>
  <position x="0" y="-60" z="12"/> <target x="0" y="0" z="12"/>
  <up x="0" y="0" z="1"/> <fov value="30"/> <focaldist value="55"/>
  <dof value="0.5"/> <width value="24"/> <height value="18"/>
</camera>
</xml>
"""

# a cube of quads (fan-triangulated), uv and normal indices, negative
# (relative) indices on the last face
CUBE = """# cube
mtllib cube.mtl
v -1 -1 -1\nv 1 -1 -1\nv 1 1 -1\nv -1 1 -1
v -1 -1 1\nv 1 -1 1\nv 1 1 1\nv -1 1 1
vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1
vn 0 0 -1\nvn 0 0 1\nvn 0 -1 0\nvn 1 0 0\nvn 0 1 0\nvn -1 0 0
usemtl shiny
f 1/1/1 4/4/1 3/3/1 2/2/1
f 5/1/2 6/2/2 7/3/2 8/4/2
f 1/1/3 2/2/3 6/3/3 5/4/3
usemtl plain
f 2/1/4 3/2/4 7/3/4 6/4/4
f 3/1/5 4/2/5 8/3/5 7/4/5
f -8/1/6 -4/2/6 -1/3/6 -5/4/6
"""

MTL = """newmtl shiny
Kd 0.8 0.2 0.2
Ks 0.5 0.5 0.5
Tf 0.2 0.3 0.4
Ns 40
Ni 1.33
illum 7
map_Kd wall.png
newmtl plain
Kd 0.3 0.6 0.3
Ks 0.4 0.4 0.4
illum 3
map_Ks sky.ppm
"""


def write_scene_set(root):
    """The file set in directory `root`; returns the XML's path."""
    from rtf_tpu_torch.utils.png import write_png
    rng = np.random.RandomState(4)
    write_png(str(root / "wall.png"),
              rng.randint(0, 256, (16, 24, 3)).astype(np.uint8))
    sky = rng.randint(0, 256, (8, 12, 3)).astype(np.uint8)
    (root / "sky.ppm").write_bytes(b"P6\n# a comment\n12 8\n255\n"
                                   + sky.tobytes())
    (root / "cube.obj").write_text(CUBE)
    (root / "cube2.obj").write_text(CUBE)
    (root / "cube.mtl").write_text(MTL)
    (root / "scene.xml").write_text(XML)
    return root / "scene.xml"


def _same(a, b, path="desc"):
    """Field-for-field equality of two descriptions (dataclasses, the
    Transform, arrays, containers) whose classes share their names."""
    assert type(a).__name__ == type(b).__name__, path
    if a is None or isinstance(a, (str, int, float, bool)):
        assert a == b, path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif hasattr(a, "__slots__"):            # Transform
        for k in a.__slots__:
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        assert vars(a).keys() == vars(b).keys(), path
        for k in vars(a):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")


def test_load_scene_matches_jax(tmp_path, capsys):
    from rtf_tpu.scene.xml_loader import load_scene as jload
    from rtf_tpu_torch.scene.xml_loader import load_scene
    xml = str(write_scene_set(tmp_path))
    ref = jload(xml)
    ref_log = capsys.readouterr().out
    port = load_scene(xml)
    port_log = capsys.readouterr().out
    _same(port, ref)
    # the missing OBJ warns in both, and its node keeps no geometry
    assert 'Cannot load file "missing.obj"' in port_log
    assert port_log == ref_log
    nodes = {n.name: n for n in port.root.children}
    assert nodes["missing.obj"].obj_kind is None
    # the OBJ named twice with a material: one mesh object, no MTL
    box = nodes["box"]
    group = next(n for n in box.children if n.name == "group")
    twice = [n for n in box.children + group.children
             if n.name == "cube.obj"]
    assert len(twice) == 2 and twice[0].mesh is twice[1].mesh
    assert twice[0].mesh.materials == []
    # without a material: the MTL's sub-materials, faces by usemtl order
    cube2 = nodes["cube2.obj"].mesh
    assert [m.name for m in cube2.materials] == ["shiny", "plain"]
    np.testing.assert_array_equal(cube2.face_mtl, [0] * 6 + [1] * 6)
    shiny, plain = cube2.materials
    assert shiny.diffuse.texmap.texture.name.endswith("wall.png")
    np.testing.assert_allclose(shiny.refraction.color, [0.8, 0.7, 0.6])
    # map_Ks binds to the specular slot (rtf_tpu's choice)
    assert plain.specular.texmap.texture.name.endswith("sky.ppm")
    assert plain.diffuse.texmap is None
    # value-scaled colours, the background's PPM texels
    np.testing.assert_allclose(port.materials["wall"].specular.color,
                               [0.1, 0.1, 0.1])
    assert set(port.materials) == {"wall", "checks", "glass"}
    assert [l.kind for l in port.lights] == ["ambient", "direct", "point"]
    assert port.background.texmap.texture.data.shape == (8, 12, 3)


def test_built_scene_file_matches_jax(tmp_path, capsys):
    """load_scene then build_scene in each package: the same tables."""
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.xml_loader import load_scene as jload
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.convert import scene_from_arrays
    from rtf_tpu_torch.scene.xml_loader import load_scene
    xml = str(write_scene_set(tmp_path))
    arrays, statics = jax_scene_arrays(jbuild(jload(xml)))
    ref = scene_from_arrays(arrays, statics, device="cpu")
    port = build_scene(load_scene(xml), device="cpu")
    # the BVH arena is built at the first "bvh" trace; rtf_tpu's comes
    # across with the rest
    ensure_bvh(port.mesh)
    capsys.readouterr()
    ref_leaves, port_leaves = scene_leaves(ref), scene_leaves(port)
    assert ref_leaves.keys() == port_leaves.keys()
    for key, a in port_leaves.items():
        b = ref_leaves[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=key)
    for key in ("width", "height", "fov", "focaldist", "dof", "bg_tm",
                "env_tm", "num_spheres", "num_planes", "num_mesh_inst",
                "num_lights", "light_kinds", "mesh_inst_slots",
                "has_file_tex", "any_soft_light", "any_glossy",
                "tm_channels"):
        assert getattr(port, key) == getattr(ref, key), key
    np.testing.assert_allclose(port.world_min, ref.world_min, atol=1e-6)
    np.testing.assert_allclose(port.world_max, ref.world_max, atol=1e-6)
    assert port.mesh.slot_faces == ref.mesh.slot_faces
    # three instances, two slots (cube.obj shared), 12 faces a slot
    assert port.num_mesh_inst == 3 and port.mesh_inst_slots == (0, 0, 1)
    assert port.mesh.tri_a.shape[0] == 24
    assert port.has_file_tex and port.bg_tm >= 0
