"""The port's image utilities (rtf_tpu_torch/utils/image.py: rmse,
zbuffer_image, sample_count_image) and render/camera.py::pixel_grid
against rtf_tpu's on seeded arrays: equal."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _z(rng, shape, misses):
    z = rng.uniform(1.0, 90.0, shape).astype(np.float32)
    if misses:
        z[rng.rand(*shape) < 0.2] = 1e30
    return z


@pytest.mark.parametrize("case", ["hits", "misses", "all miss", "flat"])
def test_zbuffer_image_matches(case):
    from rtf_tpu.utils.image import zbuffer_image as jz
    from rtf_tpu_torch.utils.image import zbuffer_image
    rng = np.random.RandomState(1)
    z = _z(rng, (24, 32), case == "misses")
    if case == "all miss":
        z[:] = 1e30
    elif case == "flat":
        z[:] = 7.5
    got = zbuffer_image(z)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jz(z))


@pytest.mark.parametrize("case", ["ladder", "flat"])
def test_sample_count_image_matches(case):
    from rtf_tpu.utils.image import sample_count_image as js
    from rtf_tpu_torch.utils.image import sample_count_image
    rng = np.random.RandomState(2)
    sc = rng.choice([4, 16, 64], (24, 32)).astype(np.int32)
    if case == "flat":
        sc[:] = 8
    got = sample_count_image(sc)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, js(sc))


def test_rmse_matches():
    from rtf_tpu.utils.image import rmse as jr
    from rtf_tpu_torch.utils.image import rmse
    rng = np.random.RandomState(3)
    a8 = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    b8 = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    af = rng.rand(24, 32, 3).astype(np.float32)
    for a, b in ((a8, b8), (af, b8), (af, af * 0.9)):
        assert rmse(a, b) == jr(a, b)


@pytest.mark.parametrize("w,h", [(32, 24), (7, 5), (800, 600)])
def test_pixel_grid_matches(w, h):
    from rtf_tpu.render.camera import pixel_grid as jgrid
    from rtf_tpu_torch.render.camera import pixel_grid
    for a, b in zip(pixel_grid(w, h), jgrid(w, h)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
