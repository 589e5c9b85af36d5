"""The sharded render (rtf_tpu_torch/parallel/mesh.py::render_sharded over
torch.distributed) on the CPU: 1, 2, 3 and 4 gloo ranks, each a
subprocess running this file's __main__ block, against the port's
single-device render and rtf_tpu's render_sharded on its 8 virtual CPU
devices (tests/test_render.py's multichip tests).

Tolerances (rtf_tpu's own): where the configs draw nothing ('both' split,
hard shadows), sample counts and hits equal, radiance within atol 5e-5
and z within 1e-5 (the spp group sums in another order than one device);
the sharded fused path against the sharded wavefront at bounces 0 within
atol 3e-4 and 1e-4 (the wave kernel's plain version against the
wavefront).  Exact (max abs error 0.0): a 1x1 mesh against
render_device_host, and 2 tiles of 1024 lanes on the fused path at 2
bounces, whose Russian roulette draws in the kernel's per-block streams
(blk0), against the single-device frame; the same 2 tiles on tables the
caller built (`tables=`: no rank builds its own) and traced (one rtf.frame
a rank, holding its rtf.prepare, waves and rtf.finalize)."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
KW = dict(min_samples=1, max_samples=1, bounces=2, shadow_min=1,
          shadow_max=1, gi_mode="none")
ADAPTIVE = dict(KW, min_samples=2, max_samples=4, variance_threshold=1e-4)
FUSED = dict(KW, min_samples=2, max_samples=2, bounces=0, split_mode="rr")
RR = dict(KW, min_samples=2, max_samples=2, bounces=2, split_mode="rr")
WORLDS = (1, 2, 3, 4)
NUM_PX = 64 * 48


def _cfg(kw):
    from rtf_tpu_torch.render.config import RenderConfig
    return RenderConfig(**kw)


def _scene(w, h):
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    return build_scene(box_scene(w, h, with_mesh=False), device="cpu")


def _worker(world, rank, port, out):
    """One rank: join the gloo group, render this world's cases, write
    rank{rank}.npz into `out`."""
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from torch import distributed as dist

    from rtf_tpu_torch.parallel.distributed import (
        init_multihost, local_tile_range)
    from rtf_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from rtf_tpu_torch.render.renderer import render_device_host
    got = init_multihost(f"localhost:{port}", world, rank, device="cpu")
    res = {"rank": got, "tile_range": np.array(local_tile_range(NUM_PX))}

    def keep(name, acc):
        for k, x in zip(("rad", "hits", "z", "ns"), acc):
            res[f"{name}_{k}"] = x.numpy()
    if world == 1:
        mesh = make_mesh(1, 1, device_type="cpu")
        for name, (w, h), kw, fused in (("adaptive", (64, 48), ADAPTIVE,
                                         None),
                                        ("rr", (64, 32), RR, True)):
            scene = _scene(w, h)
            keep(name, render_sharded(scene, _cfg(kw), mesh, seed=0,
                                      fused=fused, device="cpu"))
            keep(name + "_single", render_device_host(
                scene, _cfg(kw), seed=0, device="cpu"))
    elif world == 2:
        from rtf_tpu_torch.render import renderer
        from rtf_tpu_torch.render.scene_tables import scene_tables
        from rtf_tpu_torch.utils import tracing
        built = []

        def counted(*a, **k):
            built.append(1)
            return scene_tables(*a, **k)
        renderer.scene_tables = counted
        mesh = make_mesh(2, 1, device_type="cpu")
        # two tiles of 1024 lanes on the fused path, Russian roulette on
        keep("rr", render_sharded(_scene(64, 32), _cfg(RR), mesh, seed=0,
                                  fused=True, device="cpu"))
        res["tables_built"] = len(built)
        # the same frame on tables built once by the caller, then traced
        scene = _scene(64, 32)
        keep("rr_tables", render_sharded(
            scene, _cfg(RR), mesh, seed=0, fused=True, device="cpu",
            tables=scene_tables(scene, "cpu")))
        res["tables_built_given"] = len(built) - res["tables_built"]
        tracing.enable()
        keep("rr_traced", render_sharded(scene, _cfg(RR), mesh, seed=0,
                                         fused=True, device="cpu"))
        spans = tracing.collect()["spans"]
        tracing.disable()
        res["span_names"] = np.array([s[0] for s in spans])
        for i, k in enumerate(("id", "parent", "frame", "start", "end")):
            res[f"span_{k}"] = np.array([-1 if s[i + 1] is None
                                         else s[i + 1] for s in spans])
    elif world == 3:
        keep("adaptive", render_sharded(_scene(64, 48), _cfg(ADAPTIVE),
                                        make_mesh(1, 3, device_type="cpu"),
                                        seed=0, device="cpu"))
    else:
        mesh = make_mesh(2, 2, device_type="cpu")
        keep("adaptive", render_sharded(_scene(64, 48), _cfg(ADAPTIVE),
                                        mesh, seed=0, device="cpu"))
        for name, fused in (("fused", True), ("wavefront", False)):
            keep(name, render_sharded(_scene(32, 24), _cfg(FUSED), mesh,
                                      seed=0, fused=fused, device="cpu"))
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's results]}: every world's ranks started at once,
    one torch thread each, each world on its own port."""
    procs = {}
    env = dict(os.environ, OMP_NUM_THREADS="1", RTF_QUIET="1")
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        port = _free_port()
        procs[world] = (out, [subprocess.Popen(
            [sys.executable, __file__, str(world), str(r), str(port),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)])
    res = {}
    for world, (out, ps) in procs.items():
        for r, p in enumerate(ps):
            log = p.communicate(timeout=300)[0]
            assert p.returncode == 0, f"world {world} rank {r}:\n{log}"
        res[world] = [dict(np.load(out / f"rank{r}.npz"))
                      for r in range(world)]
    return res


def _acc(res, name):
    return [res[f"{name}_{k}"] for k in ("rad", "hits", "z", "ns")]


def _close(got, ref, rad_atol=5e-5, z_atol=1e-5, rad_rtol=0.0, z_rtol=0.0):
    rad, hits, z, ns = got
    erad, ehits, ez, ens = ref
    np.testing.assert_array_equal(ns, ens)
    np.testing.assert_array_equal(hits, ehits)
    np.testing.assert_allclose(rad, erad, atol=rad_atol, rtol=rad_rtol)
    np.testing.assert_allclose(z, ez, atol=z_atol, rtol=z_rtol)


def _single(kw, w, h, **extra):
    from rtf_tpu_torch.render.renderer import render_device_host
    return [x.numpy() for x in render_device_host(
        _scene(w, h), _cfg(kw), seed=0, device="cpu", **extra)]


@pytest.mark.parametrize("world", [3, 4])
def test_sharded_matches_single_device(runs, world):
    """(n_tile, n_spp) = (2, 2) on 4 ranks and (1, 3) on 3 ranks, the
    adaptive rungs on: every rank returns the same frame, and it is the
    single-device frame (rtf_tpu's tolerances)."""
    ranks = runs[world]
    got = _acc(ranks[0], "adaptive")
    for r in ranks[1:]:
        for a, b in zip(_acc(r, "adaptive"), got):
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3, NUM_PX) and np.isfinite(got[0]).all()
    assert (got[1] >= 1).all()
    assert got[3].min() == 2 and got[3].max() == 4     # escalation ran
    _close(got, _single(ADAPTIVE, 64, 48))


def test_sharded_matches_jax_render_sharded(runs):
    """The 2x2 frame against rtf_tpu's render_sharded over its 8 virtual
    CPU devices (a 4x2 mesh), the same scene, config and seed: radiance
    sums (of up to 4 samples, values up to 10) within atol 5e-5 plus rtol
    1e-5 and z (about 47) within 1e-5 plus rtol 1e-6: the two packages'
    camera rays and sums round apart by up to 6e-6 relative in radiance
    (3 of 9216 values) and 2.3e-7 in z (15 of 3072)."""
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from rtf_tpu.parallel.mesh import make_mesh
    from rtf_tpu.parallel.mesh import render_sharded as jsharded
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    ref = jsharded(jbuild(jbox(64, 48, with_mesh=False)), JConfig(
        **ADAPTIVE), make_mesh(n_tile=4, n_spp=2), seed=0, fused=False)
    _close(_acc(runs[4][0], "adaptive"), [np.asarray(x) for x in ref],
           rad_rtol=1e-5, z_rtol=1e-6)


def test_sharded_fused_matches_sharded_wavefront(runs):
    """The sharded fused path (the plain wave here) against the sharded
    wavefront on 2x2 ranks, bounces 0, hard shadows."""
    got = _acc(runs[4][0], "fused")
    _close(got, _acc(runs[4][0], "wavefront"), rad_atol=3e-4, z_atol=1e-4)
    assert (got[1] >= 1).all() and got[0].mean() > 0.05


def test_sharded_fused_tiles_exact(runs):
    """Two tiles of 1024 lanes (64x32) on the fused path at 2 bounces with
    Russian roulette: each tile's blk0 keys the kernel's random streams as
    the single-device launch does, so the frame is the single-device
    frame bit for bit (and a 1x1 mesh too)."""
    ref = _single(RR, 64, 32)
    for got in (_acc(runs[2][0], "rr"), _acc(runs[2][1], "rr"),
                _acc(runs[1][0], "rr")):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_sharded_reuses_given_tables(runs):
    """render_sharded(..., tables=scene_tables(...)) gives the frame of the
    call without them bit for bit, on each rank, and builds no tables;
    without them each rank builds its own once."""
    for res in runs[2]:
        for a, b in zip(_acc(res, "rr_tables"), _acc(res, "rr")):
            np.testing.assert_array_equal(a, b)
        assert int(res["tables_built"]) == 1
        assert int(res["tables_built_given"]) == 0


def test_sharded_frame_spans(runs):
    """With tracing on, a rank's sharded frame is one rtf.frame span that
    holds one rtf.prepare, every rtf.wave and one rtf.finalize, as
    `render`'s frame does; tracing changes no output bit."""
    for res in runs[2]:
        for a, b in zip(_acc(res, "rr_traced"), _acc(res, "rr")):
            np.testing.assert_array_equal(a, b)
        names = list(res["span_names"])
        sp = {k: res[f"span_{k}"] for k in ("id", "frame", "start", "end")}
        frames = [i for i, n in enumerate(names) if n == "rtf.frame"]
        assert len(frames) == 1
        f = frames[0]
        waves = [i for i, n in enumerate(names) if n == "rtf.wave"]
        assert len(waves) == RR["max_samples"]
        for n in ("rtf.prepare", "rtf.finalize"):
            assert [sp["frame"][i] for i, m in enumerate(names)
                    if m == n] == [sp["id"][f]]
        for i in waves:
            assert sp["frame"][i] == sp["id"][f]
            assert sp["start"][f] <= sp["start"][i] <= sp["end"][i] \
                <= sp["end"][f]


def test_one_rank_mesh_is_render_device_host(runs):
    """A 1x1 mesh: render_sharded equals render_device_host bit for bit
    in the same process (the adaptive config on the wavefront)."""
    res = runs[1][0]
    for a, b in zip(_acc(res, "adaptive"), _acc(res, "adaptive_single")):
        np.testing.assert_array_equal(a, b)
    assert _acc(res, "adaptive")[3].max() == 4


@pytest.mark.parametrize("world", WORLDS)
def test_local_tile_range(runs, world):
    """Each rank's contiguous lane range, the last taking the remainder:
    together they cover the frame once, in rank order."""
    ranges = [tuple(r["tile_range"]) for r in runs[world]]
    assert [int(r["rank"]) for r in runs[world]] == list(range(world))
    per = NUM_PX // world
    assert ranges == [(i * per, (i + 1) * per if i + 1 < world else NUM_PX)
                      for i in range(world)]


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
