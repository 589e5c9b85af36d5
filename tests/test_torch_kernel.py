"""The wave kernel (csrc/wave_kernel.cu) against its plain PyTorch version
on the card, and the wrapper's device rules.

Tests marked `cuda` need a CUDA card and nvcc; they skip elsewhere.  On
the card run them with `python -m pytest tests/test_torch_kernel.py`.
Tolerances are chip_smoke.py's: bounce 0 exact hit masks, atol 2e-4 and
z rtol 1e-4; past bounce 0 at most 1% of lanes outside 2e-4 (a rounding
flip of a Russian-roulette choice) and the mean within 1%.  Dead lanes
(the "-dead" cases, as the adaptive ladder's later rungs mask pixels) give
exactly zero radiance and no hit.  The "textured" cases (file textures,
an environment map and a checker; tests/test_torch_common.py) run the
kernel's textured variant, counted in `launches_textured`.  The GI rows
(surface and photon-query rows, render/wave.py::split_rows) of bounce 0
agree on every lane within 2e-4 + 1e-4 |x|, past bounce 0 on all but 1%
of lanes with the mean within 1%."""
import pytest
import torch

from test_torch_common import checker_desc, textured_desc


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _setup(desc, dev):
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    scene = build_scene(desc, device=dev)
    order = torch.as_tensor(pixel_order(scene.width, scene.height),
                            device=dev).to(torch.int64)
    o3, d3 = primary_rays_ch(scene, order % scene.width,
                             order // scene.width, torch.tensor(1))
    alive = torch.ones(o3.shape[1], dtype=torch.bool, device=dev)
    return scene_tables(scene), o3, d3, alive


def _cfg(**kw):
    from rtf_tpu_torch.render.config import RenderConfig
    base = dict(min_samples=8, max_samples=8, bounces=0, shadow_min=1,
                shadow_max=1, gi_mode="none")
    base.update(kw)
    return RenderConfig(**base)


def _desc(name):
    from rtf_tpu_torch.scene.procedural import box_scene
    name = name.removesuffix("-dead")
    if name == "checker":
        return checker_desc(64, 48)
    if name == "textured":
        return textured_desc(64, 48)
    return box_scene(64, 48, mesh_subdiv=1,
                     light_size=1.0 if name == "soft" else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,bounces,seed", [
    ("box", 0, 123), ("soft", 0, 2 ** 31 - 5), ("checker", 0, 1),
    ("box", 4, 2 ** 31 - 5), ("soft", 4, 77), ("box-dead", 4, 31),
    ("soft-dead", 0, 8), ("textured", 0, 3), ("textured", 4, 2 ** 31 - 5),
    ("textured-dead", 4, 9)])
def test_kernel_matches_plain(cuda_dev, name, bounces, seed):
    from rtf_tpu_torch.render import wave as W
    soft = name.startswith("soft")
    cfg = _cfg(bounces=bounces, shadow_min=4 if soft else 1,
               shadow_max=16 if soft else 1, split_mode="rr",
               env_on_reflect_miss=name.startswith("textured"))
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    assert tables.textured == name.startswith("textured")
    if name.endswith("-dead"):
        alive[::2] = False
    pr, ph, pz = W.wave_plain(cfg, tables, o3, d3, alive, seed)
    before = W.launches + W.launches_textured
    kr, kh, kz = W.wave(cfg, tables, o3, d3, alive, seed)
    torch.cuda.synchronize()
    assert W.launches + W.launches_textured == before + 1
    assert torch.equal(kh, ph)
    assert not bool(kh[~alive].any())
    assert bool((kr[:, ~alive] == 0).all())
    err = (kr - pr).abs()
    if bounces == 0:
        assert float(err.max()) <= 2e-4
        torch.testing.assert_close(kz[ph], pz[ph], rtol=1e-4, atol=0.0)
    else:
        assert float((err > 2e-4).any(0).float().mean()) <= 0.01
        assert abs(float(kr.mean()) / float(pr.mean()) - 1.0) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "textured"])
def test_kernel_work_counters(cuda_dev, name):
    from rtf_tpu_torch.render import wave as W
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    stats = torch.zeros(W.NSTAT, dtype=torch.int64, device=cuda_dev)
    alive[::2] = False
    W.wave(_cfg(bounces=2, split_mode="rr", env_on_reflect_miss=True),
           tables, o3, d3, alive, 5, stats=stats)
    st = stats.tolist()
    rays, hits, shadow = st[:3]
    assert int(alive.sum()) <= rays <= 3 * int(alive.sum())
    assert hits <= rays and shadow == hits
    tex_file, tex_checker, env = st[8:11]
    if name == "box":
        assert tex_file == tex_checker == env == 0
    else:
        # kd and ks of every hit sample one map each at most; every env
        # sample is one file-texture sample
        assert 0 < env <= rays - hits and 0 < tex_checker <= hits
        assert env < tex_file <= 2 * hits + env


def _rows_close(plain, kern, alive, gi_from):
    """GI rows, kernel against plain: rows of bounce 0 on every lane
    within 2e-4 + 1e-4 |x|; past bounce 0 at most 1% of lanes outside
    and the mean within 1%; finite; no query weight on dead lanes."""
    (pr, ph, pz, ps, pq), (kr, kh, kz, ks, kq) = plain, kern
    assert torch.equal(kh, ph) and len(kq) == len(pq)
    # the radiance of these waves runs past bounce 0
    assert float(((kr - pr).abs() > 2e-4).any(0).float().mean()) <= 0.01
    assert abs(float(kr.mean()) / float(pr.mean()) - 1.0) < 0.01
    rows = [] if ps is None else [(0, ps, ks)]
    rows += [(gi_from + k, torch.cat(p), torch.cat(q))
             for k, (p, q) in enumerate(zip(pq, kq))]
    for b, p, k in rows:
        assert bool(torch.isfinite(k).all())
        off = ((k - p).abs() > 2e-4 + 1e-4 * p.abs()).any(0)
        assert float(off.float().mean()) <= (0.0 if b == 0 else 0.01)
        if b > 0:
            assert abs(float(k.mean()) - float(p.mean())) \
                <= 0.01 * abs(float(p.mean())) + 1e-6
    for q in kq:
        assert not bool((q[2][:, ~alive] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "textured"])
@pytest.mark.parametrize("case", ["surf", "gi_from=1", "gi_from=0", "child",
                                  "child rows"])
def test_kernel_rows_match_plain(cuda_dev, name, case):
    """The GI rows (surf_out, gi_from) and a hemisphere child wave
    (non-unit throughput, RT_REFRACT, every other lane dead; with and
    without query rows) in both variants."""
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.gi import child_wave_args
    cfg = _cfg(bounces=2, split_mode="rr", hemisphere_samples=4,
               env_on_reflect_miss=name == "textured")
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    kw = {"surf": dict(surf_out=True),
          "gi_from=1": dict(surf_out=True, gi_from=1)}.get(
              case, dict(surf_out=True, gi_from=0))
    args, gi_from = (o3, d3, alive, 13), kw.get("gi_from", 0)
    if case.startswith("child"):
        _, hit0, _, surf, _ = W.wave_plain(cfg, tables, *args, **kw)
        half = alive.clone()
        half[::2] = False
        u = torch.rand((2, alive.shape[0]), device=cuda_dev,
                       generator=torch.Generator(cuda_dev).manual_seed(1))
        args, kw = child_wave_args(cfg, surf, hit0, half, 13, 1, u[0], u[1])
        gi_from = 0
        if case == "child rows":
            kw["gi_from"] = 0
    plain = W.wave_plain(cfg, tables, *args, **kw)
    kern = W.wave(cfg, tables, *args, **kw)
    torch.cuda.synchronize()
    if case == "child":
        assert torch.equal(kern[1], plain[1])
        err = (kern[0] - plain[0]).abs()
        assert float((err > 2e-4).any(0).float().mean()) <= 0.01
        assert abs(float(kern[0].mean()) / float(plain[0].mean()) - 1.0) \
            < 0.01
        return
    _rows_close(plain, kern, args[2], gi_from)


def test_wave_refuses_other_devices():
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    tables = scene_tables(build_scene(box_scene(8, 6, mesh_subdiv=0),
                                      device="cpu"))
    o3 = torch.zeros((3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        W.wave(_cfg(), tables, o3, o3, torch.ones(4, dtype=torch.bool),
               0)
