"""The flat-shaded preview (rtf_tpu_torch/render/renderer.py::preview)
against rtf_tpu's on the CPU, on the 32x24 box (the 80-face ball;
rtf_tpu's mesh test in its Pallas kernel's arithmetic,
mesh_algo="pallas_interpret") carried across: per pixel, image bytes
within 1 and z within rtol 1e-4 on hits, misses equal.  Without a lens one
pinhole frame; with a lens (dof 0.4) 4 lens-jittered frames averaged, the
port fed rtf_tpu's lens draws (per frame key split(PRNGKey(seed), 4)[f],
its two uniforms from split of that key).  A lens with the default of 0
frames takes 32, deterministic in the seed."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402


def _scenes(dof):
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    desc = box_scene(32, 24, mesh_subdiv=1)
    desc.camera.dof = dof
    js = dataclasses.replace(build_scene(desc), mesh_algo="pallas_interpret")
    return js, port_scene_from_jax(js)


def _lens_draws(seed, frames, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), frames)
    out = []
    for kf in keys:
        k1, k2 = jax.random.split(kf)
        out.append(np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                             np.asarray(jax.random.uniform(k2, (n,)))]))
    return torch.as_tensor(np.stack(out))


@pytest.mark.parametrize("lens", [False, True])
def test_preview_matches_jax(lens):
    from rtf_tpu.render.renderer import preview as jpreview
    from rtf_tpu_torch.render.renderer import preview
    js, ps = _scenes(0.4 if lens else 0.0)
    frames = 4 if lens else 0
    ref = jpreview(js, dof_frames=frames, seed=3)
    got = preview(ps, dof_frames=frames, seed=3, device="cpu",
                  lens_u=_lens_draws(3, 4, 32 * 24) if lens else None)
    assert got.image.shape == (24, 32, 3) and got.image.dtype == np.uint8
    diff = np.abs(got.image.astype(int) - ref.image.astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.05, diff.max()
    hit = ref.z < 1e29
    np.testing.assert_array_equal(got.z < 1e29, hit)
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    np.testing.assert_array_equal(got.sample_count, 1)
    assert got.image.std() > 1.0


def test_preview_lens_default_frames():
    from rtf_tpu_torch.render.renderer import preview
    _, ps = _scenes(0.4)
    pin = preview(ps, dof_frames=1, device="cpu")
    blur = preview(ps, device="cpu")
    again = preview(ps, device="cpu")
    np.testing.assert_array_equal(blur.image, again.image)
    assert np.abs(pin.image.astype(int) - blur.image.astype(int)).mean() \
        > 0.5
