"""The port's command line (rtf_tpu_torch/cli.py), in-process with
`--device cpu`, on a scene file this file writes: a Proj3-era box (five
planes, the floor's kd a PNG texture, a mirror and a glass sphere, an
ambient and a point light; no mesh, so rtf_tpu's CPU mesh path plays no
part) at 32x24.

- `render --profile proj3` against rtf_tpu's CLI on the same file: proj3
  draws no random number, so tests/test_torch_wavefront.py's pixel rule
  holds on the 8-bit images (bytes within 1, unequal on at most 0.5% of
  pixels), and the z-buffer and sample-count PNGs are equal;
- `viz` on one .dat writes the same bytes as rtf_tpu's;
- `watch --spp 4` (passes of 1, 2 and 1 spp from Halton index 0, 1 and 3:
  `sample_base`) equals `render_device_host` at 4 spp accumulator for
  accumulator: hits, sample counts and z equal, radiance within 1e-6 (the
  passes group the sums differently); `watch --resume` continues from its
  state to the same accumulators; `view` writes all three modes from it;
- `probe` prints `render`'s pixel; `photons` writes a .dat that
  `load_photon_dat` reads back with the stored count; `preview` and
  `render --gi-cache` write their images.
"""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401

W, H = 32, 24

XML = f"""<xml><scene>
<object name="box"><translate z="12"/>
<object type="plane" name="floor" material="floor">
<scale value="32"/><translate z="-12"/></object>
<object type="plane" name="ceiling" material="wall">
<scale value="32"/><rotate x="1" angle="180"/><translate z="12"/></object>
<object type="plane" name="back" material="wall">
<scale value="32"/><rotate x="1" angle="90"/><translate y="20"/></object>
<object type="plane" name="left" material="red">
<scale value="32"/><rotate y="1" angle="90"/><translate x="-15"/></object>
<object type="plane" name="right" material="blue">
<scale value="32"/><rotate y="1" angle="-90"/><translate x="15"/></object>
</object>
<object type="sphere" name="mirror" material="mirror">
<scale value="4"/><translate x="7" y="-2" z="4"/></object>
<object type="sphere" name="glass" material="glass">
<scale value="4"/><translate x="-7" y="2" z="4"/></object>
<material type="blinn" name="floor">
<diffuse value="0.8" texture="floor.png"><scale value="0.25"/></diffuse>
<specular value="0.2"/><glossiness value="10"/></material>
<material type="blinn" name="wall"><diffuse value="0.7"/>
<specular value="0"/></material>
<material type="blinn" name="red"><diffuse r="0.8" g="0.2" b="0.2"/>
<specular value="0"/></material>
<material type="blinn" name="blue"><diffuse r="0.2" g="0.2" b="0.8"/>
<specular value="0"/></material>
<material type="blinn" name="mirror"><diffuse value="0.1"/>
<specular value="0.9"/><glossiness value="80"/><reflection value="0.8"/>
</material>
<material type="blinn" name="glass"><diffuse value="0.05"/>
<specular value="0.9"/><glossiness value="80"/>
<refraction value="0.9" index="1.5"/></material>
<light type="ambient" name="amb"><intensity value="0.15"/></light>
<light type="point" name="lamp"><intensity value="0.8"/>
<position x="-4" y="-6" z="21"/></light>
</scene><camera><position x="0" y="-60" z="12"/>
<target x="0" y="0" z="12"/><up x="0" y="0" z="1"/><fov value="30"/>
<width value="{W}"/><height value="{H}"/></camera></xml>
"""


def write_cli_scene(root):
    """The scene file and its PNG texture in `root`; returns the XML's
    path as a string."""
    from rtf_tpu_torch.utils.png import write_png
    rng = np.random.RandomState(6)
    write_png(str(root / "floor.png"),
              rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    (root / "box.xml").write_text(XML)
    return str(root / "box.xml")


def port(*argv):
    from rtf_tpu_torch.cli import main
    return main([*argv, "--device", "cpu"])


def read(path):
    from rtf_tpu_torch.utils.png import read_png
    return read_png(str(path))


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    return write_cli_scene(tmp_path_factory.mktemp("cli"))


def test_render_matches_jax(scene_file, tmp_path):
    from rtf_tpu.cli import main as jmain
    outs = {}
    for who in ("port", "jax"):
        paths = [tmp_path / f"{who}_{k}.png" for k in ("img", "z", "sc")]
        argv = ["render", scene_file, "--profile", "proj3", "--out",
                str(paths[0]), "--zbuffer", str(paths[1]), "--samplecount",
                str(paths[2])]
        assert (port(*argv) if who == "port" else jmain(argv)) == 0
        outs[who] = [read(p) for p in paths]
    img, ref = (outs[k][0].astype(int) for k in ("port", "jax"))
    assert img.shape == (H, W, 3) and img.std() > 5.0
    diff = np.abs(img - ref).max(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, diff.max()
    for k in (1, 2):
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k])


def test_viz_matches_jax(tmp_path):
    from rtf_tpu.cli import main as jmain
    from rtf_tpu_torch.cli import main
    from rtf_tpu_torch.gi.io import save_photon_dat
    rng = np.random.RandomState(8)
    n = 3000
    d = rng.normal(size=(n, 3))
    save_photon_dat(str(tmp_path / "pm.dat"),
                    rng.uniform(-10, 10, (n, 3)),
                    d / np.linalg.norm(d, axis=1, keepdims=True),
                    rng.uniform(0.0, 2.0, (n, 3)))
    for who, fn in (("port", main), ("jax", jmain)):
        assert fn(["viz", str(tmp_path / "pm.dat"), "--out",
                   str(tmp_path / f"{who}.png"), "--width", "96",
                   "--height", "64", "--angle", "30"]) == 0
    got = (tmp_path / "port.png").read_bytes()
    assert got == (tmp_path / "jax.png").read_bytes()
    assert read(tmp_path / "port.png").max() > 0


def _accumulators(scene_file, spp):
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import render_device_host
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.xml_loader import load_scene
    scene = build_scene(load_scene(scene_file), device="cpu")
    cfg = PROFILES["proj3"].with_(min_samples=spp, max_samples=spp)
    return [x.numpy() for x in render_device_host(scene, cfg, 0,
                                                  device="cpu")]


def _same_accumulators(state, ref):
    rad, hits, z, ns = ref
    np.testing.assert_array_equal(state["hits"], hits)
    np.testing.assert_array_equal(state["ns"], ns)
    np.testing.assert_array_equal(state["z"], z)
    np.testing.assert_allclose(state["rad"], rad, rtol=0, atol=1e-6)
    assert hits.max() == 4 and rad.max() > 0.1


def test_watch_equals_render(scene_file, tmp_path, capsys):
    state = tmp_path / "w.npz"
    assert port("watch", scene_file, "--profile", "proj3", "--spp", "4",
                "--out", str(tmp_path / "w.png"), "--state",
                str(state)) == 0
    text = capsys.readouterr().out
    assert "[preview]" in text and "[4/4 spp]" in text
    # passes of 1, 2 and 1 spp, each with its wave progress line
    assert re.findall(r"\[(\d)/4 spp\]", text) == ["1", "3", "4"]
    assert "pass wave 2/2" in text
    st = np.load(state)
    assert int(st["done"]) == 4 and int(st["pass_ix"]) == 3
    assert str(st["profile"]) == "proj3" and int(st["num_px"]) == W * H
    _same_accumulators(st, _accumulators(scene_file, 4))
    # the watch image is the 4-spp render's
    ref = tmp_path / "r.png"
    assert port("render", scene_file, "--profile", "proj3", "--spp", "4",
                "--out", str(ref)) == 0
    np.testing.assert_array_equal(read(tmp_path / "w.png"), read(ref))


def test_watch_resume_and_view(scene_file, tmp_path, capsys):
    out = tmp_path / "r.png"
    argv = ["watch", scene_file, "--profile", "proj3", "--out", str(out),
            "--resume", "--no-progress"]
    assert port(*argv, "--spp", "2") == 0
    state = tmp_path / "r.png.state.npz"
    assert int(np.load(state)["done"]) == 2
    assert port(*argv, "--spp", "4") == 0
    assert "resumed at 2 spp" in capsys.readouterr().out
    st = np.load(state)
    assert int(st["done"]) == 4
    _same_accumulators(st, _accumulators(scene_file, 4))
    for mode in ("image", "z", "samplecount"):
        view = tmp_path / f"v_{mode}.png"
        assert port("view", scene_file, str(state), "--mode", mode,
                    "--out", str(view)) == 0
        assert read(view).shape[:2] == (H, W)
    np.testing.assert_array_equal(read(tmp_path / "v_image.png"), read(out))
    assert read(tmp_path / "v_z.png").std() > 1.0


def test_probe_prints_render_pixel(scene_file, capsys):
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.xml_loader import load_scene
    assert port("probe", scene_file, "--pixel", "9,14") == 0
    text = capsys.readouterr().out
    res = render(build_scene(load_scene(scene_file), device="cpu"),
                 PROFILES["proj3"], seed=0, device="cpu")
    c = res.radiance[14, 9]
    assert f"color (linear): {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}" in text
    assert f"color (8-bit):  {tuple(int(v) for v in res.image[14, 9])}" \
        in text
    assert f"z: {float(res.z[14, 9]):.6f}" in text and "samples: 1" in text


def test_photons_preview_and_cache(scene_file, tmp_path, capsys):
    from rtf_tpu_torch.gi.io import load_photon_dat
    dat = tmp_path / "pm.dat"
    assert port("photons", scene_file, "--count", "2000", "--out",
                str(dat)) == 0
    stored = int(re.search(r"stored (\d+) photons",
                           capsys.readouterr().out).group(1))
    pos, dirs, power = load_photon_dat(str(dat))
    assert 0 < stored == len(pos) == len(dirs) == len(power)
    assert np.isfinite(pos).all() and (power > 0).any()

    pv = tmp_path / "p.png"
    assert port("preview", scene_file, "--out", str(pv)) == 0
    assert read(pv).shape == (H, W, 3) and read(pv).std() > 1.0

    gc = tmp_path / "g.png"
    assert port("render", scene_file, "--profile", "proj11", "--gi-cache",
                "--spp", "1", "--bounces", "1", "--out", str(gc)) == 0
    text = capsys.readouterr().out
    assert re.search(r"irradiance cache: \d+% of pixels traced", text)
    assert "Render time is" in text and read(gc).std() > 1.0


def test_progress_callback_counts_waves():
    """render_device_host calls progress_cb after every wave of both
    adaptive phases, up to the ladder's top (rtf_tpu's unit), whether or
    not the second phase covers every pixel."""
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render_device_host
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(16, 12, mesh_subdiv=0), device="cpu")
    cfg = RenderConfig(min_samples=2, max_samples=4, bounces=1,
                       shadow_min=1, shadow_max=1, split_mode="rr")
    calls = []
    acc = render_device_host(scene, cfg, 0, device="cpu",
                             progress_cb=lambda d, t: calls.append((d, t)))
    assert calls == [(k, 4) for k in range(1, 5)]
    plain = render_device_host(scene, cfg, 0, device="cpu")
    for a, b in zip(acc, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
