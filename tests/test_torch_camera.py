"""The camera's Halton sub-pixel offsets (rtf_tpu_torch/render/camera.py,
core/halton.py): a sample wave's scalar index takes memoised host offsets
and makes no copy from the host, with rays equal bit for bit to the
offsets computed as tensors and copied to the lanes' device (the frozen
copies below); on the card a fused frame's ladder makes no synchronising
call (`cuda` case, which skips here)."""
import numpy as np
import pytest
import torch

from rtf_tpu_torch.core.halton import halton
from rtf_tpu_torch.render import camera, renderer
from rtf_tpu_torch.render.camera import (
    image_plane_params, pixel_grid, primary_rays, primary_rays_ch,
)
from rtf_tpu_torch.render.config import RenderConfig
from rtf_tpu_torch.scene.build import build_scene
from rtf_tpu_torch.scene.procedural import box_scene
from rtf_tpu_torch.utils import tracing

HIT, MISS = "camera.offsets.hit", "camera.offsets.miss"


def halton_frozen(index, base, max_index=1 << 16):
    """halton as it was: the digit weight a float32 tensor copied to the
    index's device before the loop and once per digit."""
    i = index.to(torch.int64)
    inv_base = torch.tensor(1.0 / base, dtype=torch.float32)
    r = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = inv_base.to(i.device)
    n, v = 0, 1
    while v <= max_index:
        v *= base
        n += 1
    for _ in range(max(n, 1)):
        r = r + f * (i % base).to(torch.float32)
        f = f * inv_base.to(i.device)
        i = i // base
    return r


def focal_points_frozen(scene, px, py, sample_idx, halton_bases):
    """_focal_points as it was: the offsets as float32 tensors, copied to
    the lanes' device."""
    u, v, b = image_plane_params(scene)
    f32 = torch.float32
    sx = halton_frozen(sample_idx, halton_bases[0]) * torch.tensor(u, dtype=f32)
    sy = halton_frozen(sample_idx, halton_bases[1]) * torch.tensor(v, dtype=f32)
    sx, sy = sx.to(px.device), sy.to(px.device)
    cx = px.to(f32) * u + float(b[0]) + sx
    cy = py.to(f32) * v + float(b[1]) + sy
    return cx, cy, torch.full_like(cx, float(b[2]))


@pytest.fixture
def cold():
    """The offset memo and its counters empty, before and after."""
    camera._OFFSETS.clear()
    tracing.reset_counters(HIT, MISS)
    yield
    camera._OFFSETS.clear()
    tracing.reset_counters(HIT, MISS)


def _rays(scene, px, py, idx, bases):
    return (primary_rays(scene, px, py, idx, halton_bases=bases)
            + primary_rays_ch(scene, px, py, idx, halton_bases=bases))


def _assert_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("bases", [(2, 3), (3, 5)])
def test_rays_equal_frozen_offsets(cold, monkeypatch, bases):
    scene = build_scene(box_scene(32, 24), device="cpu")
    px, py = pixel_grid(32, 24)
    # a frame's waves, and a pass of the CLI's watch at sample_base 70000
    indices = list(range(301)) + [70000 + j for j in range(4)]
    new = [_rays(scene, px, py, torch.tensor(j), bases) for j in indices]
    lanes = torch.arange(px.shape[0], dtype=torch.int64) * 37 % 1000
    new_lanes = _rays(scene, px, py, lanes, bases)
    monkeypatch.setattr(camera, "_focal_points", focal_points_frozen)
    for j, got in zip(indices, new):
        _assert_equal(got, _rays(scene, px, py, torch.tensor(j), bases))
    _assert_equal(new_lanes, _rays(scene, px, py, lanes, bases))
    assert tracing.counter(MISS) == 2 * len(indices)


def test_halton_equals_frozen_loop():
    idx = torch.arange(70001, dtype=torch.int64)
    for base in (2, 3, 5, 7):
        assert torch.equal(halton(idx, base), halton_frozen(idx, base))
        for j in (0, 1, 255, 1023, 65535, 70000):
            got = halton(torch.tensor(j), base)
            assert got.shape == () and torch.equal(
                got, halton_frozen(torch.tensor(j), base))
    assert halton(idx.to(torch.int32), 2).dtype == torch.float32


def test_memo_counts_and_leaves_frame_unchanged(cold, monkeypatch):
    scene = build_scene(box_scene(32, 24), device="cpu")
    cfg = RenderConfig(min_samples=2, max_samples=2, bounces=2,
                       shadow_min=1, shadow_max=1, split_mode="rr")
    cold_res = renderer.render(scene, cfg, seed=5, device="cpu")
    assert (tracing.counter(MISS), tracing.counter(HIT)) == (4, 0)
    warm_res = renderer.render(scene, cfg, seed=5, device="cpu")
    assert (tracing.counter(MISS), tracing.counter(HIT)) == (4, 4)
    monkeypatch.setattr(camera, "_focal_points", focal_points_frozen)
    frozen = renderer.render(scene, cfg, seed=5, device="cpu")
    for k in ("image", "radiance", "z", "sample_count"):
        a = getattr(cold_res, k)
        assert np.array_equal(a, getattr(warm_res, k)), k
        assert np.array_equal(a, getattr(frozen, k)), k


def test_memo_is_bounded(cold):
    for j in range(camera._OFFSETS_MAX + 10):
        camera._offset(j, 2, 0.5)
    assert len(camera._OFFSETS) == camera._OFFSETS_MAX
    assert (0, 2, 0.5) not in camera._OFFSETS
    assert camera._offset(9, 2, 0.5) == float(
        halton_frozen(torch.tensor(9), 2) * torch.tensor(0.5))


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fused_ladder_makes_no_sync(cuda_dev, monkeypatch):
    """A fused frame on the MXU tables, its adaptive ladder under
    set_sync_debug_mode("error"): any call inside the waves that waits
    for the card raises."""
    from rtf_tpu_torch.render.scene_tables import mesh_mode, render_path
    scene = build_scene(box_scene(160, 120, mesh_subdiv=3), device=cuda_dev)
    cfg = RenderConfig(min_samples=4, max_samples=8, bounces=4,
                       shadow_min=1, shadow_max=1, split_mode="rr")
    assert render_path(scene, cfg)[0] == "fused"
    assert mesh_mode(scene) == "mxu"
    want = renderer.render(scene, cfg, seed=9, device=cuda_dev)
    ladder = renderer.adaptive_ladder

    def strict(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return ladder(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(renderer, "adaptive_ladder", strict)
    got = renderer.render(scene, cfg, seed=9, device=cuda_dev)
    for k in ("image", "radiance", "z", "sample_count"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
