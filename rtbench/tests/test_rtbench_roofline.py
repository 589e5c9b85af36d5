"""The roofline byte counts on shapes worked out by hand."""
import pytest

from rtbench import roofline

FACTS = {"faces": 320, "spheres": 2, "planes": 5, "mesh_instances": 1,
         "lights": 1, "materials": 6, "texels": 100, "textured": False}


def test_scene_words():
    # 320 faces x 9 + 8 instances x 13 + a light's 11 + 6 materials x 22
    assert roofline.scene_words(FACTS) == 2880 + 104 + 11 + 132
    tex = dict(FACTS, textured=True)
    assert roofline.scene_words(tex) == 3127 + 300


def test_wave_bytes_primary():
    # 1000 lanes: 7 words in, 5 out
    assert roofline.wave_bytes(1000, False, False, 0, FACTS) == \
        4 * (1000 * 12 + 3127)


def test_wave_bytes_child_with_rows():
    # a child wave's state (7 more in), surface rows (12) and 2 GI bounces
    # (9 each) out
    assert roofline.wave_bytes(10, True, True, 2, FACTS) == \
        4 * (10 * (7 + 7 + 5 + 12 + 18) + 3127)


def test_share():
    least = roofline.least_seconds(3.35e9)
    assert least == pytest.approx(1e-3)
    assert roofline.share(least, 4e-3) == pytest.approx(25.0)
    assert roofline.share(least, 0.0) is None
