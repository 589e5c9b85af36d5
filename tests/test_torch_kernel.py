"""The kernels (csrc/wave_kernel.cu, mesh_hit.cu, mesh_hit_mxu.cu,
bvh_hit.cu's two walks) against their plain PyTorch versions on the card,
and the wrapper's device rules.

Tests marked `cuda` need a CUDA card and nvcc; they skip elsewhere.  On
the card run them with `python -m pytest --noconftest
tests/test_torch_kernel.py`.
Tolerances are chip_smoke.py's: bounce 0 exact hit masks, atol 2e-4 and
z rtol 1e-4; past bounce 0 at most 1% of lanes outside 2e-4 (a rounding
flip of a Russian-roulette choice) and the mean within 1%.  Dead lanes
(the "-dead" cases, as the adaptive ladder's later rungs mask pixels) give
exactly zero radiance and no hit.  The "textured" cases (file textures,
an environment map and a checker; tests/test_torch_common.py) run the
kernel's textured variant, counted in launches.wave_kernel.textured; the
"mxu-" cases the 1280-face ball on the MXU tables (the MXU variants,
counted in launches.wave_kernel.mxu and .textured_mxu), and the dense
Plücker closest hit (csrc/mesh_hit_mxu.cu, a tensor-core sign filter and
an exact FP32 re-check) runs against its plain version bit for bit, on cases that
stress the filter, and its counters against plain counts.  The walk's
edge cases on the MXU tables (ties across tiles and instances, two
instances, the 81,920-face ball, shared or device memory for the upper
levels, the textured variant's GI rows), the same on the immediates
variants (all four: untextured and textured, with GI rows or not),
mesh_closest_hit (csrc/mesh_hit.cu; ties across tiles, two instances,
dead and padding lanes), every MXU variant on the 20,480-face ball (its
launches' block order changing no output and no work count) and the
wavefront frame's determinism are exact: max abs error 0.0.  The GI rows
(surface and photon-query rows, render/wave.py::split_rows) of bounce 0
agree on every lane within 2e-4 + 1e-4 |x|, past bounce 0 on all but 1%
of lanes with the mean within 1%."""
import pytest
import torch

from rtf_tpu_torch.utils.tracing import counter
from test_torch_common import (
    checker_desc, face_rays, mxu_walk_desc, textured_desc, vertex_rays)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def bvh_launches():
    """(wide walk, binary walk) launches of bvh_closest_hit so far."""
    return (counter("launches.bvh_closest_hit"),
            counter("launches.bvh_closest_hit.binary"))


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
    """The scene of a case name: box, soft (a sized light), checker or
    textured, each with the 80-face ball; with the prefix "mxu-" the
    1280-face ball (the kernel's MXU variants)."""
    from rtf_tpu_torch.scene.procedural import box_scene
    name = name.removesuffix("-dead")
    subdiv = 3 if name.startswith("mxu-") else 1
    name = name.removeprefix("mxu-")
    if name == "checker":
        return checker_desc(64, 48)
    if name == "textured":
        return textured_desc(64, 48, mesh_subdiv=subdiv)
    return box_scene(64, 48, mesh_subdiv=subdiv,
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
    keys = ("launches.wave_kernel", "launches.wave_kernel.textured")
    before = sum(map(counter, keys))
    kr, kh, kz = W.wave(cfg, tables, o3, d3, alive, seed)
    torch.cuda.synchronize()
    assert sum(map(counter, keys)) == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("name,bounces,seed", [
    ("mxu-box", 0, 123), ("mxu-soft", 0, 2 ** 31 - 5), ("mxu-box", 4, 31),
    ("mxu-soft", 4, 77), ("mxu-box-dead", 4, 5), ("mxu-soft-dead", 0, 8),
    ("mxu-textured", 0, 3), ("mxu-textured", 4, 2 ** 31 - 5),
    ("mxu-textured-dead", 4, 9)])
def test_mxu_kernel_matches_plain(cuda_dev, name, bounces, seed):
    """The MXU variants (wave_kernel<*, *, true>) against wave_plain on the
    1280-face ball, with the tolerances of test_kernel_matches_plain."""
    from rtf_tpu_torch.render import wave as W
    textured = "textured" in name
    soft = "soft" in name
    cfg = _cfg(bounces=bounces, shadow_min=4 if soft else 1,
               shadow_max=16 if soft else 1, split_mode="rr",
               env_on_reflect_miss=textured)
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    assert tables.mxu and tables.textured == textured
    if name.endswith("-dead"):
        alive[::2] = False
    pr, ph, pz = W.wave_plain(cfg, tables, o3, d3, alive, seed)
    key = W.launch_counter(tables)
    before = counter(key)
    kr, kh, kz = W.wave(cfg, tables, o3, d3, alive, seed)
    torch.cuda.synchronize()
    assert counter(key) == before + 1
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
@pytest.mark.parametrize("name", ["mxu-box", "mxu-textured"])
@pytest.mark.parametrize("case", ["surf", "gi_from=0", "child rows"])
def test_mxu_kernel_rows_match_plain(cuda_dev, name, case):
    """The GI rows of the MXU variants and a hemisphere child wave with its
    query rows, every other lane dead, against wave_plain (`_rows_close`)."""
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.gi import child_wave_args
    cfg = _cfg(bounces=2, split_mode="rr", hemisphere_samples=4,
               env_on_reflect_miss=name == "mxu-textured")
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    kw = dict(surf_out=True) if case == "surf" \
        else dict(surf_out=True, gi_from=0)
    args = (o3, d3, alive, 13)
    if case == "child rows":
        _, hit0, _, surf, _ = W.wave_plain(cfg, tables, *args, **kw)
        half = alive.clone()
        half[::2] = False
        u = torch.rand((2, alive.shape[0]), device=cuda_dev,
                       generator=torch.Generator(cuda_dev).manual_seed(1))
        args, kw = child_wave_args(cfg, surf, hit0, half, 13, 1, u[0], u[1])
        kw["gi_from"] = 0
    plain = W.wave_plain(cfg, tables, *args, **kw)
    kern = W.wave(cfg, tables, *args, **kw)
    torch.cuda.synchronize()
    _rows_close(plain, kern, args[2], 0)


def _assert_exact(plain, kern):
    """Every output of the kernel equals the plain version's bit for bit
    (max abs error 0.0): radiance, hit mask, z and any rows."""
    for p, k in zip(plain, kern):
        if isinstance(p, list):
            for pq, kq in zip(p, k):
                for a, b in zip(pq, kq):
                    assert torch.equal(a, b)
        elif p is not None:
            assert torch.equal(p, k), float((p.float() - k.float()).abs()
                                            .max())


@pytest.mark.cuda
@pytest.mark.parametrize("case,bounces,staged", [
    ("tie", 0, True), ("tie", 4, True), ("tie", 0, False),
    ("tie", 4, False), ("twin", 0, True), ("twin", 4, False),
    ("two", 0, True), ("two", 4, False), ("big", 0, True),
    ("big", 4, False)])
def test_mxu_walk_exact(cuda_dev, monkeypatch, case, bounces, staged):
    """The hierarchical MXU walk against wave_plain with max abs error 0.0
    where an out-of-order walk could go wrong: exact ties at equal t
    across tiles ("tie"; the frame's rays, one ray per face and one per
    face vertex, a hit on its boxes' faces) and across
    instances ("twin"), two instances of one ball, one transformed
    ("two"), the 81,920-face ball ("big"), with the roots and groups in
    shared memory or in device memory."""
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.scene.procedural import box_scene
    if not staged:
        monkeypatch.setattr(W, "SMEM_BYTES", 0)
    desc = box_scene(64, 48, mesh_subdiv=6) if case == "big" \
        else mxu_walk_desc(case, 64, 48)
    tables, o3, d3, alive = _setup(desc, cuda_dev)
    assert tables.mxu and W.smem_staged(tables) == staged
    if case != "big":
        from rtf_tpu_torch.scene.build import build_scene
        scene = build_scene(desc, device=cuda_dev)
        fo, fd = face_rays(scene, cuda_dev)
        vo, vd = vertex_rays(scene, cuda_dev)
        o3, d3 = torch.cat([o3, fo, vo], 1), torch.cat([d3, fd, vd], 1)
        alive = torch.ones(o3.shape[1], dtype=torch.bool, device=cuda_dev)
    cfg = _cfg(bounces=bounces, split_mode="rr")
    plain = W.wave_plain(cfg, tables, o3, d3, alive, 21)
    before = counter("launches.wave_kernel.mxu")
    kern = W.wave(cfg, tables, o3, d3, alive, 21)
    torch.cuda.synchronize()
    assert counter("launches.wave_kernel.mxu") == before + 1
    assert int(kern[1].sum()) > 100
    _assert_exact(plain, kern)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_mxu_textured_rows_exact(cuda_dev, monkeypatch, staged):
    """The textured MXU variant with GI rows (surface rows, a query per
    bounce from bounce 0) against wave_plain, max abs error 0.0."""
    from rtf_tpu_torch.render import wave as W
    if not staged:
        monkeypatch.setattr(W, "SMEM_BYTES", 0)
    cfg = _cfg(bounces=2, split_mode="rr", env_on_reflect_miss=True)
    tables, o3, d3, alive = _setup(_desc("mxu-textured"), cuda_dev)
    assert tables.mxu and tables.textured
    assert W.smem_staged(tables) == staged
    kw = dict(surf_out=True, gi_from=0)
    plain = W.wave_plain(cfg, tables, o3, d3, alive, 13, **kw)
    kern = W.wave(cfg, tables, o3, d3, alive, 13, **kw)
    torch.cuda.synchronize()
    _assert_exact(plain, kern)


@pytest.mark.cuda
def test_mxu_walk_counters(cuda_dev):
    """The MXU counters: root-box tests and passes (walks), each level's
    slab tests (the 1280-face ball has 2 groups), pairs, cycles by part
    within the bounce loop's, warp-iterations with 1-32 active lanes, and
    each block's cycles after the counters."""
    from rtf_tpu_torch.render import wave as W
    tables, o3, d3, alive = _setup(_desc("mxu-box"), cuda_dev)
    n = o3.shape[1]
    stats = torch.zeros(W.stats_size(n), dtype=torch.int64, device=cuda_dev)
    W.wave(_cfg(bounces=2, split_mode="rr"), tables, o3, d3, alive, 5,
           stats=stats)
    st = stats.tolist()
    root, groups, leaves = st[11:14]
    tiles, pairs, walks = st[3], st[4] + st[5], st[22]
    assert root == st[7] and 0 < walks < root and 0 < groups <= 2 * walks
    assert 0 < tiles <= 8 * groups and 0 < leaves <= 8 * tiles
    assert 0 < pairs <= 16 * leaves
    cyc_root, cyc_walk, cyc_pair, cyc_bounces = st[14:18]
    assert min(cyc_root, cyc_walk, cyc_pair) > 0
    assert cyc_root + cyc_walk + cyc_pair < cyc_bounces
    for it, lanes in ((st[18], st[19]), (st[20], st[21])):
        assert 0 < it <= lanes <= 32 * it
    blocks = st[W.NSTAT:]
    assert len(blocks) == (n + 127) // 128 and min(blocks) > 0


def _ball_tables(dev, textured=False, soft=False):
    """The wave's inputs on the 20,480-face ball (20 groups),
    the textured box's ball for `textured`: tables, the 64x48 frame's
    rays plus one ray per face and one per face vertex, all alive."""
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    desc = textured_desc(64, 48, mesh_subdiv=5) if textured \
        else box_scene(64, 48, mesh_subdiv=5, light_size=1.0 if soft else 0.0)
    tables, o3, d3, _ = _setup(desc, dev)
    assert tables.mxu and tables.textured == textured
    assert int(tables.roots[0, 7]) == 20
    scene = build_scene(desc, device=dev)
    fo, fd = face_rays(scene, dev)
    vo, vd = vertex_rays(scene, dev)
    o3, d3 = torch.cat([o3, fo, vo], 1), torch.cat([d3, fd, vd], 1)
    return tables, o3, d3, torch.ones(o3.shape[1], dtype=torch.bool,
                                      device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case,bounces,staged", [
    ("box", 0, True), ("box", 4, True), ("box", 4, False), ("soft", 4, True),
    ("gi", 2, True), ("gi", 2, False), ("textured", 4, True),
    ("textured-gi", 2, True), ("textured-gi", 2, False)])
def test_ball_walk_exact(cuda_dev, monkeypatch, case, bounces, staged):
    """Every MXU variant of the wave kernel (untextured or textured, with
    GI rows or not: the pair rows, the shade rows, the block order),
    closest hits and shadow rays (hard, or soft with up to 16), the roots
    and groups in shared memory or in device memory: against wave_plain
    with max abs error 0.0 on the 20,480-face ball's frame, face and
    vertex rays."""
    from rtf_tpu_torch.render import wave as W
    if not staged:
        monkeypatch.setattr(W, "SMEM_BYTES", 0)
    soft = case == "soft"
    tables, o3, d3, alive = _ball_tables(cuda_dev, "textured" in case, soft)
    assert W.smem_staged(tables) == staged
    cfg = _cfg(bounces=bounces, split_mode="rr", hemisphere_samples=4,
               shadow_min=4 if soft else 1, shadow_max=16 if soft else 1,
               env_on_reflect_miss="textured" in case)
    kw = dict(surf_out=True, gi_from=0) if case.endswith("gi") else {}
    plain = W.wave_plain(cfg, tables, o3, d3, alive, 21, **kw)
    key = W.launch_counter(tables)
    before = counter(key)
    kern = W.wave(cfg, tables, o3, d3, alive, 21, **kw)
    torch.cuda.synchronize()
    assert counter(key) == before + 1
    assert int(kern[1].sum()) > 1000
    _assert_exact(plain, kern)


@pytest.mark.cuda
def test_wave_args_size(cuda_dev):
    """The built library's struct Args has the size of its Python mirror
    (_build.WaveArgs; tests/test_torch_launch.py holds their fields to
    each other), which _build.load checks too."""
    import ctypes
    from rtf_tpu_torch import _build
    lib = _build.load("wave")
    assert lib.rtf_wave_args_size() == ctypes.sizeof(_build.WaveArgs)


@pytest.mark.cuda
def test_launch_failure_raises(cuda_dev):
    """A launch function's error code comes back as RuntimeError naming
    the function and the library's error string (the wide walk refuses a
    stack need of 0)."""
    from rtf_tpu_torch import _build
    x = torch.zeros((4, 3), device=cuda_dev)
    t = torch.zeros(4, device=cuda_dev)
    with pytest.raises(RuntimeError, match="rtf_bvh_wide_launch failed: "
                       "invalid argument"):
        _build.launch("bvh_hit", "rtf_bvh_wide_launch", cuda_dev, x, x, 3,
                      t, 1, 4, t, t, 0, 0, t, t, t, t, t, None)


@pytest.mark.cuda
def test_block_order_keeps_outputs(cuda_dev, monkeypatch):
    """The MXU launch's block order pass (csrc/wave_kernel.cu::block_order)
    changes only when each block runs and how its warps walk: on the
    20,480-face ball's rays the outputs and every work count but the
    cycles and the warp-iterations equal, bit for bit, those of the same
    launch with its order scratch passed as null (the blocks in their own
    order).  The order's count of walking blocks picks the one-loop walk
    (one_loop), whose lanes test their leaves' faces together, so its face
    loops take fewer warp-iterations for the same face tests; a launch
    without an order walks nested."""
    from rtf_tpu_torch import _build
    from rtf_tpu_torch.render import wave as W
    tables, o3, d3, alive = _ball_tables(cuda_dev)
    cfg = _cfg(bounces=2, split_mode="rr")
    lib = _build.load()

    class Unordered:
        def rtf_wave_launch(self, args, textured, mxu, order, stream):
            return lib.rtf_wave_launch(args, textured, mxu, None, stream)

        def rtf_error_string(self, code):
            return lib.rtf_error_string(code)
    runs = {}
    for name in ("ordered", "unordered"):
        if name == "unordered":
            monkeypatch.setattr(_build, "load",
                                lambda name="wave": Unordered())
        stats = torch.zeros(W.NSTAT, dtype=torch.int64, device=cuda_dev)
        out = W.wave(cfg, tables, o3, d3, alive, 7, stats=stats)
        torch.cuda.synchronize()
        runs[name] = out, stats.tolist()
    _assert_exact(runs["ordered"][0], runs["unordered"][0])
    cycles = {14, 15, 16, 17, 23, 24, 25}     # STAT_CYC_*
    iters = {18, 20}                          # STAT_WALK_ITERS, _PAIR_ITERS
    for s, (a, b) in enumerate(zip(runs["ordered"][1],
                                   runs["unordered"][1])):
        assert s in cycles | iters or a == b, s
    assert runs["ordered"][1][22] > 1000      # STAT_ROOT_IN: walks
    assert runs["ordered"][1][20] < runs["unordered"][1][20]


@pytest.mark.cuda
def test_wavefront_frame_is_deterministic(cuda_dev):
    """The 160x120 wavefront frame (soft shadows, the 'both' split)
    rendered twice on the same inputs is the same bit for bit: the splat
    sums each pixel's lanes in lane order, without atomics."""
    import numpy as np

    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(160, 120, light_size=1.0),
                        device=cuda_dev)
    cfg = RenderConfig(min_samples=2, max_samples=2)
    assert render_path(scene, cfg)[0] == "wavefront"
    a = render(scene, cfg, seed=5, device=cuda_dev)
    b = render(scene, cfg, seed=5, device=cuda_dev)
    assert np.array_equal(a.radiance, b.radiance)
    assert np.array_equal(a.z, b.z) and a.radiance.mean() > 0


@pytest.mark.cuda
def test_mesh_mxu_kernel_matches_plain(cuda_dev):
    """csrc/mesh_hit_mxu.cu against mesh_closest_hit_mxu_plain: 8192 rays
    at the subdiv-4 icosphere (5120 faces, ten 512-face tiles), a quarter
    of them with t_init 0 (as padding rays), face0 = 77: all five outputs
    equal bit for bit."""
    from rtf_tpu_torch.ops import mesh_hit_mxu as M
    from rtf_tpu_torch.scene.procedural import icosphere_mesh
    m = icosphere_mesh(4)
    a, b, c = (m.v[m.f[:, k]] for k in range(3))
    trim = torch.as_tensor(M.pack_tri_matrix(a, b, c), device=cuda_dev)
    g = torch.Generator(cuda_dev).manual_seed(2)
    n = 8192
    o = torch.randn((n, 3), generator=g, device=cuda_dev)
    o = 4.0 * o / o.norm(dim=1, keepdim=True)
    d = torch.rand((n, 3), generator=g, device=cuda_dev) * 2.4 - 1.2 - o
    d = d / d.norm(dim=1, keepdim=True)
    t0 = torch.full((n,), 100.0, device=cuda_dev)
    t0[::4] = 0.0
    rays16, _ = M.pack_rays16(o, d, t0)
    before = counter("launches.mesh_closest_hit_mxu")
    kern = M.mesh_closest_hit_mxu(rays16, trim, 77)
    plain = M.mesh_closest_hit_mxu_plain(rays16, trim, 77)
    torch.cuda.synchronize()
    assert counter("launches.mesh_closest_hit_mxu") == before + 1
    assert 0.3 < float((kern[1] >= 0).float().mean()) < 0.75
    assert not bool((kern[1][::4] >= 0).any())
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)


def _dense_case(case, dev):
    """(rays16, trim, face0) for the dense kernel's exact cases on the
    subdiv-4 icosphere (5120 faces): "edge" and "vertex" one ray per face
    at an edge midpoint or a corner; "ties" face 7 repeated at column 300
    of tile 0 and at column 100 of tile 1, rays at its edges; "tile128"
    the first 1000 faces in 128-face tiles (the last one short) with
    faces 3 and 9 degenerate; "far" the ball moved 1000 along every axis;
    "cut" scattered rays, face0 = 1000, t_init cutting the ball, N = 1037
    (no whole block)."""
    import numpy as np

    from rtf_tpu_torch.ops import mesh_hit_mxu as M
    from test_torch_common import dense_rays, icosphere_faces
    a, b, c = icosphere_faces(4, 1000.0 if case == "far" else 0.0)
    tile, face0, t_init, kind = 512, 0, 1e30, case
    if case == "ties":
        a, b, c = (x.copy() for x in (a, b, c))
        for col in (300, 512 + 100):
            a[col], b[col], c[col] = a[7], b[7], c[7]
        kind = "edge"
    elif case == "tile128":
        a, b, c = (x[:1000].copy() for x in (a, b, c))
        b[3] = a[3]
        b[9] = c[9] = a[9]
        tile, kind = 128, "vertex"
    elif case == "far":
        kind = "vertex"
    elif case == "cut":
        kind, face0 = "scattered", 1000
    o, d = dense_rays(kind, a, b, c, n=1037)
    if case == "ties":
        o, d = o[[7, 300, 612] * 300], d[[7, 300, 612] * 300]
        o = o + np.random.RandomState(3).normal(0, 0.01, o.shape).astype(
            np.float32)
    n = len(o)
    if case == "cut":
        t_init = np.random.RandomState(4).uniform(0.5, 3.0, n).astype(
            np.float32)
    rays16, _ = M.pack_rays16(torch.as_tensor(o, device=dev),
                              torch.as_tensor(d, device=dev),
                              torch.as_tensor(t_init, device=dev).expand(n)
                              .contiguous())
    trim = torch.as_tensor(M.pack_tri_matrix(a, b, c, tile), device=dev)
    return rays16[:n].contiguous(), trim, face0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge", "vertex", "ties", "tile128", "far",
                                  "cut"])
def test_mesh_mxu_kernel_exact(cuda_dev, case):
    """The dense kernel's filter under stress (rays at edges and corners,
    ties in a tile and across tiles, short tiles with degenerate faces,
    faces 1e3 from the origin, t_init cutting hits, face0 = 1000, a ragged
    last block): all five outputs equal the plain version's bit for bit."""
    from rtf_tpu_torch.ops import mesh_hit_mxu as M
    rays16, trim, face0 = _dense_case(case, cuda_dev)
    kern = M.mesh_closest_hit_mxu(rays16, trim, face0)
    plain = M.mesh_closest_hit_mxu_plain(rays16, trim, face0)
    torch.cuda.synchronize()
    assert int((plain[1] >= 0).sum()) > 50
    if case == "ties":
        assert not bool(((plain[1] == 300) | (plain[1] == 612)).any())
    for k, p in zip(kern, plain):
        assert torch.equal(k, p), float((k.float() - p.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge", "cut", "far"])
def test_mesh_mxu_kernel_counts(cuda_dev, case):
    """The counting instantiation: pairs filtered = live rays x faces kept;
    valid pairs = plucker_pair's count over live rays (a valid pair is
    never rejected); pairs re-checked between the emulated filter's
    survivors at EPS - 2^-18 and at EPS + 2^-16 (the tensor cores sum
    within 2^-18 of the exact sums of the TF32 values, and the kernel's
    FP16 rounding of the sums near -2 EPS keeps pairs within 2^-17 more);
    tiles with a survivor no more than the pairs re-checked."""
    from rtf_tpu_torch.ops import mesh_hit_mxu as M
    from rtf_tpu_torch.ops.mxu_pack import plucker_pair
    rays16, trim, face0 = _dense_case(case, cuda_dev)
    stats = torch.zeros(M.NSTAT, dtype=torch.int64, device=cuda_dev)
    kern = M.mesh_closest_hit_mxu(rays16, trim, face0, stats=stats)
    plain = M.mesh_closest_hit_mxu_plain(rays16, trim, face0)
    filtered, rechecked, valid, tiles = stats.tolist()
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    pack = M.pack_faces(trim)
    f = pack.rows.shape[0]
    a, live = M.ray_frags(rays16)
    s = M.filter_margins(a, M.unpack_frags(pack.frags, f))
    cols = [pack.rows[:, k][None, :] for k in range(22)]
    d3, c3, o3 = (tuple(rays16[:, k:k + 1] for k in range(b, b + 3))
                  for b in (0, 3, 6))
    ok = plucker_pair(cols, d3, c3, o3)[1] & live[:, None]
    assert filtered == int(live.sum()) * f
    assert valid == int(ok.sum()) > 0
    lo = int(M.filter_survivors(s, live, M.EPS - 2.0 ** -18).sum())
    hi = int(M.filter_survivors(s, live, M.EPS + 2.0 ** -16).sum())
    assert lo <= rechecked <= hi, (lo, rechecked, hi)
    assert 0 < tiles <= rechecked


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


def _mesh_inputs(case, dev):
    """The arguments the wavefront hands mesh_closest_hit: rays8, the
    slot's table columns and boxes, face0, and the MeshTree and slot as
    keywords: camera rays of the 64x48 box in the ball's local space
    ("camera"; "dead": every other lane from the dead-lane sentinel;
    "capped": a finite t_init that cuts the ball; "tie": the 2,561-face
    ball whose faces are listed twice; "two": the second of two instances
    of one ball), or 4096 random rays aimed at it ("random"; "padding":
    the first 1000 of them, padded to 1024, a quarter with t_init 0);
    "ball", "ball-random": the camera or random rays on the 20,480-face
    ball, 20 groups)."""
    from rtf_tpu_torch.ops.mesh_hit import pack_rays
    from rtf_tpu_torch.ops.trace import _to_local
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    desc = mxu_walk_desc(case, 64, 48) if case in ("tie", "two") \
        else box_scene(64, 48, mesh_subdiv=5 if case.startswith("ball")
                       else 2)
    scene = build_scene(desc, device=dev)
    if case in ("random", "padding", "ball-random"):
        g = torch.Generator(dev).manual_seed(7)
        o = torch.rand((4096, 3), generator=g, device=dev) * 40.0 - 20.0
        d = torch.rand((4096, 3), generator=g, device=dev) * 6.0 \
            + torch.tensor([-2.0, 1.0, 0.0], device=dev) - o
        d = d / d.norm(dim=1, keepdim=True)
    else:
        order = torch.as_tensor(pixel_order(64, 48),
                                device=dev).to(torch.int64)
        o, d = primary_rays(scene, order % 64, order // 64, torch.tensor(2))
        if case == "dead":
            o = o.clone()
            o[::2] = 1.0e7
    t_init = torch.full((o.shape[0],), 1e30, device=dev)
    if case == "capped":
        t_init = 60.0 + 6.0 * torch.rand(
            o.shape[0], generator=torch.Generator(dev).manual_seed(3),
            device=dev)
    k = 1 if case == "two" else 0
    lo, ld = _to_local(scene.mesh_inst.itm[k], scene.mesh_inst.pos[k], o, d)
    if case == "padding":
        lo, ld, t_init = lo[:1000], ld[:1000], t_init[:1000].clone()
        t_init[::4] = 0.0
    rays8, _ = pack_rays(lo, ld, t_init)
    slot = int(scene.mesh_inst_slots[k])
    col0, fpad, ar0, nt, _ = scene.mesh.slot_pack[slot]
    return ((rays8, scene.mesh.tri_packed[:, col0:col0 + fpad],
             scene.mesh.tile_aabb[ar0:ar0 + nt], col0),
            dict(tree=scene.mesh.hit_tree, slot=slot))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["camera", "dead", "capped", "random",
                                  "tie", "two", "padding", "unpacked",
                                  "ball", "ball-random"])
def test_mesh_kernel_matches_plain(cuda_dev, case):
    """csrc/mesh_hit.cu against mesh_closest_hit_plain on the same inputs:
    faces (and so hit masks) equal, t, front, ba and bb with max abs error
    0.0 (both round the same operations in the same order, and both pick
    the least t, then the least packed id); "unpacked": the camera rays
    through mesh_closest_hit_rays, as a trace hands them over."""
    from rtf_tpu_torch.ops import mesh_hit as M
    args, kw = _mesh_inputs("camera" if case == "unpacked" else case,
                            cuda_dev)
    before = counter("launches.mesh_closest_hit")
    if case == "unpacked":
        r8 = args[0]
        kern = M.mesh_closest_hit_rays(
            r8[:, 0:3].contiguous(), r8[:, 3:6].contiguous(),
            r8[:, 6].contiguous(), *args[1:], **kw)
    else:
        kern = M.mesh_closest_hit(*args, **kw)
    plain = M.mesh_closest_hit_plain(*args)
    torch.cuda.synchronize()
    assert counter("launches.mesh_closest_hit") == before + 1
    assert torch.equal(kern[1], plain[1])
    assert int((kern[1] >= 0).sum()) > 20
    if case == "padding":
        assert not bool((kern[1][::4] >= 0).any())
        assert not bool((kern[1][1000:] >= 0).any())
    for k, p in zip(kern[0:1] + kern[2:], plain[0:1] + plain[2:]):
        assert torch.equal(k, p), float((k - p).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case,bounces", [
    ("tie", 0), ("tie", 4), ("twin", 4), ("two", 0), ("two", 4),
    ("box-dead", 4), ("soft", 4), ("textured", 0), ("textured", 4),
    ("textured-dead", 4)])
def test_imm_walk_exact(cuda_dev, case, bounces):
    """The immediates variants' walk (wave_kernel<*, *, false>) against
    wave_plain with max abs error 0.0: ties at equal t across tiles
    ("tie": the 80-face ball listed twice; the frame's rays, one ray per
    face and one per face vertex) and across instances ("twin"), two
    instances of one ball ("two"), every other lane dead, soft shadows,
    and the textured variant on the textured box (the 80-face ball)."""
    from rtf_tpu_torch.render import wave as W
    name = case.removesuffix("-dead")
    textured = name == "textured"
    desc = mxu_walk_desc(name, 64, 48, subdiv=1) \
        if name in ("tie", "twin", "two") else _desc(name)
    tables, o3, d3, alive = _setup(desc, cuda_dev)
    assert not tables.mxu and tables.textured == textured
    if name in ("tie", "twin", "two"):
        from rtf_tpu_torch.scene.build import build_scene
        scene = build_scene(desc, device=cuda_dev)
        fo, fd = face_rays(scene, cuda_dev)
        vo, vd = vertex_rays(scene, cuda_dev)
        o3, d3 = torch.cat([o3, fo, vo], 1), torch.cat([d3, fd, vd], 1)
        alive = torch.ones(o3.shape[1], dtype=torch.bool, device=cuda_dev)
    if case.endswith("-dead"):
        alive[::2] = False
    soft = name == "soft"
    cfg = _cfg(bounces=bounces, split_mode="rr",
               shadow_min=4 if soft else 1, shadow_max=16 if soft else 1,
               env_on_reflect_miss=textured)
    plain = W.wave_plain(cfg, tables, o3, d3, alive, 21)
    key = W.launch_counter(tables)
    before = counter(key)
    kern = W.wave(cfg, tables, o3, d3, alive, 21)
    torch.cuda.synchronize()
    assert counter(key) == before + 1
    assert int(kern[1].sum()) > 100
    _assert_exact(plain, kern)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "textured"])
@pytest.mark.parametrize("staged", [True, False])
def test_scene_tables_staged_or_not_exact(cuda_dev, monkeypatch, name,
                                          staged):
    """The kernel with the small scene tables (spheres, planes, mesh
    instances, lights) in shared memory, and with them in device memory
    (the fallback where they do not fit, forced), against wave_plain with
    max abs error 0.0."""
    from rtf_tpu_torch.render import wave as W
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    assert W.scene_staged(tables)
    if not staged:
        monkeypatch.setattr(W, "scene_staged", lambda tables: False)
    cfg = _cfg(bounces=4, split_mode="rr",
               env_on_reflect_miss=name == "textured")
    plain = W.wave_plain(cfg, tables, o3, d3, alive, 9)
    kern = W.wave(cfg, tables, o3, d3, alive, 9)
    torch.cuda.synchronize()
    _assert_exact(plain, kern)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "textured"])
@pytest.mark.parametrize("case", ["rows", "child rows"])
def test_imm_rows_exact(cuda_dev, name, case):
    """The immediates GI variants (wave_kernel<*, true, false>): surface
    rows and a query per bounce from bounce 0, and a hemisphere child
    wave with query rows, every other lane dead, against wave_plain with
    max abs error 0.0."""
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.gi import child_wave_args
    cfg = _cfg(bounces=2, split_mode="rr", hemisphere_samples=4,
               env_on_reflect_miss=name == "textured")
    tables, o3, d3, alive = _setup(_desc(name), cuda_dev)
    assert not tables.mxu
    kw = dict(surf_out=True, gi_from=0)
    args = (o3, d3, alive, 13)
    if case == "child rows":
        _, hit0, _, surf, _ = W.wave_plain(cfg, tables, *args, **kw)
        half = alive.clone()
        half[::2] = False
        u = torch.rand((2, alive.shape[0]), device=cuda_dev,
                       generator=torch.Generator(cuda_dev).manual_seed(1))
        args, kw = child_wave_args(cfg, surf, hit0, half, 13, 1, u[0], u[1])
        kw["gi_from"] = 0
    plain = W.wave_plain(cfg, tables, *args, **kw)
    kern = W.wave(cfg, tables, *args, **kw)
    torch.cuda.synchronize()
    _assert_exact(plain, kern)


@pytest.mark.cuda
def test_wavefront_on_the_card_runs_the_kernel(cuda_dev, monkeypatch):
    """A wavefront frame on the card launches mesh_closest_hit for every
    trace and never calls the plain version."""
    from rtf_tpu_torch.ops import mesh_hit as M
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(M, "mesh_closest_hit_plain", refuse)
    scene = build_scene(box_scene(32, 24, light_size=1.0), device=cuda_dev)
    cfg = RenderConfig(min_samples=2, max_samples=2, bounces=2)
    before = counter("launches.mesh_closest_hit")
    res = render(scene, cfg, device=cuda_dev)
    # per wave 1 + bounces shade_lanes of 1 + 4 + 16 traces
    assert counter("launches.mesh_closest_hit") - before == 2 * 3 * 21
    assert res.image.mean() > 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["pallas", "pallas_interpret"])
def test_no_mesh_algo_runs_the_plain_version_on_the_card(cuda_dev,
                                                         monkeypatch, algo):
    """Every mesh_algo the port accepts launches the kernel on CUDA
    tensors: trace and trace_shadow never reach the plain version."""
    import dataclasses

    from rtf_tpu_torch.ops import mesh_hit as M
    from rtf_tpu_torch.ops.trace import MESH_ALGOS, trace, trace_shadow
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(M, "mesh_closest_hit_plain", refuse)
    assert algo in MESH_ALGOS
    scene = dataclasses.replace(
        build_scene(box_scene(32, 24), device=cuda_dev), mesh_algo=algo)
    order = torch.as_tensor(pixel_order(32, 24),
                            device=cuda_dev).to(torch.int64)
    o, d = primary_rays(scene, order % 32, order // 32, torch.tensor(0))
    before = counter("launches.mesh_closest_hit")
    hit = trace(scene, o, d)
    lit = trace_shadow(scene, o, d, 1.0)
    torch.cuda.synchronize()
    assert counter("launches.mesh_closest_hit") - before == 2
    assert bool(hit.is_hit.any()) and lit.shape == (o.shape[0],)


def _plain_rays(lo, ld, t_init, tris, aabb, face0=0, stats=None, **k):
    """mesh_closest_hit's plain version in mesh_closest_hit_rays' place."""
    from rtf_tpu_torch.ops import mesh_hit as M
    rays8, _ = M.pack_rays(lo, ld, t_init)
    return tuple(x[:lo.shape[0]] for x in M.mesh_closest_hit_plain(
        rays8, tris, aabb, face0))


@pytest.mark.cuda
def test_photon_chunk_kernel_matches_plain(cuda_dev, monkeypatch):
    """One chunk of 131,072 global photons on the textured box (the
    320-face ball), shot twice from one generator seed: with
    mesh_closest_hit (photon_bounces + 1 launches) and with its plain
    version in the kernel's place (no launch).  The maps (count, pos, dir,
    power), their grids and the volumes baked from them are equal bit for
    bit."""
    from rtf_tpu_torch.gi.grid import build_photon_grid
    from rtf_tpu_torch.gi.photon import shoot_photons
    from rtf_tpu_torch.gi.volume import build_irradiance_volume
    from rtf_tpu_torch.ops import mesh_hit as M
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    scene = build_scene(textured_desc(64, 48, mesh_subdiv=2),
                        device=cuda_dev)
    tables = scene_tables(scene)
    cfg = RenderConfig()

    def shoot():
        pm = shoot_photons(scene, cfg, 131072, 131072 * cfg.photon_bounces,
                           torch.Generator(cuda_dev).manual_seed(3),
                           tables=tables)
        grid = build_photon_grid(pm, cfg.knn_radius, scene.world_min,
                                 scene.world_max)
        return pm, grid, build_irradiance_volume(
            grid, cfg.knn_radius, cfg.knn_k, scene.world_min,
            scene.world_max)
    key = "launches.mesh_closest_hit"
    before = counter(key)
    kern = shoot()
    assert counter(key) - before == cfg.photon_bounces + 1
    monkeypatch.setattr(M, "mesh_closest_hit_rays", _plain_rays)
    plain = shoot()
    assert counter(key) - before == cfg.photon_bounces + 1
    assert 50000 < int(kern[0].count) < 131072 * cfg.photon_bounces
    for a, b in zip(kern[0], plain[0]):
        assert torch.equal(a, b)
    for k in ("pos", "cell_start", "cell_count"):
        assert torch.equal(getattr(kern[1], k), getattr(plain[1], k))
    assert torch.equal(kern[2].table, plain[2].table)
    assert bool(torch.isfinite(kern[2].table).all())


@pytest.mark.cuda
def test_render_shoots_photons_with_the_kernel(cuda_dev):
    """`render` with photon GI and no map on the card: its photon pass
    launches mesh_closest_hit once per trace (one chunk, photon_bounces +
    1 traces), the frame the wave kernel's GI launches, and the frame is
    the same bit for bit when rendered twice."""
    import numpy as np

    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    scene = build_scene(textured_desc(64, 48, mesh_subdiv=2),
                        device=cuda_dev)
    cfg = RenderConfig(min_samples=2, max_samples=2, bounces=2,
                       shadow_min=1, shadow_max=1, split_mode="rr",
                       gi_mode="photon", hemisphere_samples=2,
                       photon_count=50000)
    m0 = counter("launches.mesh_closest_hit")
    w0 = counter("launches.wave_kernel.textured")
    a = render(scene, cfg, seed=4, device=cuda_dev)
    assert counter("launches.mesh_closest_hit") - m0 \
        == cfg.photon_bounces + 1
    assert counter("launches.wave_kernel.textured") - w0 == 2 * (1 + 2)
    b = render(scene, cfg, seed=4, device=cuda_dev)
    assert np.array_equal(a.radiance, b.radiance)
    assert np.isfinite(a.radiance).all() and a.image.mean() > 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "textured"])
def test_cache_evaluator_exact(cuda_dev, name):
    """The irradiance cache's fused evaluator at 160x120 on the kernel
    (its untextured and textured GI variants) against the same call on
    the plain wave, one draw seed each: equal bit for bit, one launch per
    hemisphere sample; the cached frame's first hits trace on
    mesh_closest_hit."""
    from rtf_tpu_torch.gi import irradiance_cache as IC
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(textured_desc(160, 120) if name == "textured"
                        else box_scene(160, 120), device=cuda_dev)
    tables = scene_tables(scene)
    m0 = counter("launches.mesh_closest_hit")
    p, n, _, _, hit, front = IC._first_hits(scene, tables)
    assert counter("launches.mesh_closest_hit") - m0 == scene.num_mesh_inst
    mask = hit & front
    cfg = _cfg(bounces=2, gi_mode="hemisphere", hemisphere_samples=4,
               split_mode="rr")
    key = W.launch_counter(tables)
    out = []
    for fn in (None, W.wave_plain):
        before = counter(key)
        draws = IC.CacheDraws(torch.Generator(device=cuda_dev).manual_seed(3))
        out.append(IC._eval_irradiance_fused(scene, cfg, tables, p, n, mask,
                                             draws, 0, wave_fn=fn))
        assert counter(key) - before == (4 if fn is None else 0)
    assert torch.equal(out[0], out[1]), float((out[0] - out[1]).abs().max())
    assert float(out[0].mean()) > 0.0


def _bvh_rays(cuda_dev, subdiv, kind):
    """test_bvh_kernel_matches_plain's scene, mesh and local rays."""
    from rtf_tpu_torch.ops.trace import _to_local
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.procedural import box_scene
    from test_torch_common import dense_rays
    scene = build_scene(box_scene(160, 120, mesh_subdiv=subdiv),
                        device=cuda_dev)
    mesh = ensure_bvh(scene.mesh)
    if kind == "scattered":
        f0, f1 = mesh.slot_faces[0]
        o, d = (torch.as_tensor(x, device=cuda_dev) for x in dense_rays(
            "scattered", *(getattr(mesh, k)[f0:f1].cpu().numpy()
                           for k in ("tri_a", "tri_b", "tri_c")),
            seed=subdiv, n=20000))
    else:
        order = torch.as_tensor(pixel_order(160, 120),
                                device=cuda_dev).to(torch.int64)
        wo, wd = primary_rays(scene, order % 160, order // 160,
                              torch.tensor(1))
        o, d = _to_local(scene.mesh_inst.itm[0], scene.mesh_inst.pos[0],
                         wo, wd)
    t_init = torch.full((o.shape[0],), 1e30, device=cuda_dev)
    if kind == "capped":
        g = torch.Generator(cuda_dev).manual_seed(3)
        t_init = torch.where(torch.rand(o.shape[0], generator=g,
                                        device=cuda_dev) < 0.5,
                             20.0 + 8.0 * torch.rand(o.shape[0], generator=g,
                                                     device=cuda_dev),
                             t_init)
    return mesh, o, d, t_init


@pytest.mark.cuda
@pytest.mark.parametrize("subdiv", [2, 5])
@pytest.mark.parametrize("kind", ["camera", "scattered", "capped"])
def test_bvh_kernel_matches_plain(cuda_dev, subdiv, kind):
    """csrc/bvh_hit.cu's wide walk (the walk bvh_walk takes on these
    trees) against its plain twin bvh_wide_closest_hit_plain and the
    lock-step bvh_closest_hit_plain on the 320- and 20,480-face balls
    (mesh_subdiv 2 and 5): the 160x120 camera's rays in the ball's local
    space, seeded scattered rays about the ball, and the camera's rays with
    seeded t_init caps.  Against the twin: every output and the work
    counters with max abs error 0.0 (per ray the same pops and tests, and
    the kernel rounds as torch does), one launch counted.  Against the
    lock-step walk: hit masks and t equal; face, front, ba and bb equal
    but on near ties (ops/bvh_hit.py::near_ties), at most 1 in 10^5
    rays."""
    from rtf_tpu_torch.ops import bvh_hit as B
    mesh, o, d, t_init = _bvh_rays(cuda_dev, subdiv, kind)
    walk = B.bvh_walk(mesh)
    assert walk.walk == "wide"
    root = int(mesh.slot_root[0])
    sk, sw = (torch.zeros(B.NSTAT, dtype=torch.int64, device=cuda_dev)
              for _ in range(2))
    before = bvh_launches()
    kern = B.bvh_closest_hit(mesh, root, o, d, t_init, stats=sk)
    twin = B.bvh_wide_closest_hit_plain(walk, root, o, d, t_init, stats=sw)
    lock = B.bvh_closest_hit_plain(mesh, root, o, d, t_init)
    torch.cuda.synchronize()
    assert bvh_launches() == (before[0] + 1, before[1])
    assert int((kern[1] >= 0).sum()) > 20
    for k, p in zip(kern, twin):
        assert torch.equal(k, p), float((k.float() - p.float()).abs().max())
    assert torch.equal(sk, sw), (sk.tolist(), sw.tolist())
    assert torch.equal(kern[1] >= 0, lock[1] >= 0)
    assert torch.equal(kern[0], lock[0])
    idx, tie = B.near_ties(mesh, o, d, kern, lock)
    assert bool(tie.all()) and idx.numel() <= max(1, o.shape[0] // 100000)


@pytest.mark.cuda
@pytest.mark.parametrize("subdiv", [2, 5])
@pytest.mark.parametrize("kind", ["camera", "scattered", "capped"])
def test_bvh_binary_walk_on_capped_tree(cuda_dev, subdiv, kind):
    """csrc/bvh_hit.cu's binary walk on test_bvh_kernel_matches_plain's
    rays: on the ball's own tree (the walk forced), and on a tree deeper
    than max_depth - 2 (max_depth set to 2 levels below the ball's, so
    bvh_traverse's stack clamp drops nodes), where bvh_walk takes it by the
    depth rule.  Each launch equals the lock-step bvh_closest_hit_plain
    bit for bit, outputs and counters, and is counted in
    launches.bvh_closest_hit.binary."""
    from rtf_tpu_torch.ops import bvh_hit as B
    mesh, o, d, t_init = _bvh_rays(cuda_dev, subdiv, kind)
    root = int(mesh.slot_root[0])
    levels = B.tree_levels(mesh.bvh_child.cpu().numpy(), root)
    full = B.build_walk(mesh, "binary")
    for capped in (False, True):
        if capped:
            mesh.max_depth = levels - 2
            assert B.bvh_walk(mesh).walk == "binary"
        sk, sp = (torch.zeros(B.NSTAT, dtype=torch.int64, device=cuda_dev)
                  for _ in range(2))
        before = bvh_launches()
        kern = (B.bvh_closest_hit(mesh, root, o, d, t_init, stats=sk)
                if capped else
                B.launch_walk(full, root, o, d, t_init, stats=sk))
        plain = B.bvh_closest_hit_plain(mesh, root, o, d, t_init, stats=sp)
        torch.cuda.synchronize()
        assert bvh_launches() == (before[0], before[1] + 1)
        assert int((kern[1] >= 0).sum()) > 20
        for k, p in zip(kern, plain):
            assert torch.equal(k, p), \
                (capped, float((k.float() - p.float()).abs().max()))
        assert torch.equal(sk, sp), (capped, sk.tolist(), sp.tolist())
