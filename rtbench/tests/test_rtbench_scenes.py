"""The benchmark's scene maker gives rtf_tpu_torch's box_scene exactly."""
import numpy as np
import pytest

from rtbench import scenes
from rtf_tpu_torch.core import transform
from rtf_tpu_torch.scene import model
from rtf_tpu_torch.scene.procedural import box_scene


def same(a, b, path="desc"):
    """Recursive equality of two descriptions: arrays bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif hasattr(a, "__slots__"):
        assert type(a) is type(b), path
        for k in a.__slots__:
            same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif hasattr(a, "__dict__"):
        assert type(a) is type(b), path
        same(vars(a), vars(b), path)
    else:
        assert a == b, path


@pytest.mark.parametrize("subdiv", [2, 7])
def test_box_equals_box_scene(subdiv):
    kw = dict(width=80, height=60, with_mesh=True, light_size=1.0,
              mesh_subdiv=subdiv)
    ours = scenes.box(scenes.kinds_of(model, transform), **kw)
    same(ours, box_scene(**kw))


def test_configs_make_their_scene():
    from rtbench import manifest
    m = manifest.load()
    for c in m["configs"]:
        cell = next(w["name"] for w in m["workloads"]
                    if w["config"] == c["name"])
        cfg = manifest.Cell(m, cell).config
        desc = scenes.make(cfg, scenes.kinds_of(model, transform), 16, 12)
        assert (desc.camera.width, desc.camera.height) == (16, 12)
        if "mesh_subdiv" in cfg["args"]:
            mesh = desc.root.children[-1].mesh
            assert len(mesh.f) == 20 * 4 ** cfg["args"]["mesh_subdiv"]
