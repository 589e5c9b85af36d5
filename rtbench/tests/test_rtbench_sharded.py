"""A cell on several cards (rtbench/sharded.py) rehearsed on the CPU: four
gloo ranks, one process each, on a copied manifest whose cell box.sharded4
renders `render_sharded` on a 1x4 spp mesh (rtbench/traffic/sharded4.json,
cut to 8 spp: 2 waves a rank) at 32x24.

Whole runs go through rtbench/rehearse.py as a process, rank 0 starting the
others.  Faults are planted in the copy's rtbench/sharded.py (its `frame`,
which every rank calls: the warm-up is call 0, the window's one frame call
1): a rank whose partial sums are dropped from the spp group's sums, the
exchange between ranks left out, a rank whose copy of the frame differs,
and a rank that raises or dies."""
import json
import os
import subprocess
import sys
import time

import pytest

from rtbench import harness, manifest, sharded
from rtbench.tests.conftest import ROOT
from rtbench.tests.test_rtbench_discovery import copy_bench

W, H = 32, 24
CELL = "box.sharded4"
RUN_LIMIT_S = 240


def copy_sharded(tmp_path, samples=8):
    """A checkout whose manifest holds box.sharded4 (4 chips, traffic
    sharded4), its traffic cut to `samples` spp."""
    root, bench = copy_bench(tmp_path)
    m = manifest.load(root)
    m["workloads"].append({"name": CELL, "config": "box",
                           "traffic": "sharded4", "chips": 4,
                           "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    p = bench / "traffic" / "sharded4.json"
    t = json.loads(p.read_text())
    t["render"].update({"min_samples": samples, "max_samples": samples})
    p.write_text(json.dumps(t))
    return root, bench


def rehearse(root, *args):
    """rehearse.py of the checkout `root` as a process: (exit code, its
    result line or None, standard error, seconds)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.monotonic()
    p = subprocess.run(
        [sys.executable, str(root / "rtbench" / "rehearse.py"),
         "--workload", CELL, "--width", str(W), "--height", str(H),
         "--seconds", "0.01", "--seed", "2147483659", *args],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=RUN_LIMIT_S)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return (p.returncode, json.loads(lines[-1]) if lines else None,
            p.stderr, time.monotonic() - t)


def rank_pids(stderr: str) -> list:
    return [int(ln.rsplit(" ", 1)[1]) for ln in stderr.splitlines()
            if ln.startswith("[rtbench] rank ") and ": pid " in ln]


def alive(pid: int) -> bool:
    """Whether the process runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


FAULTS = {
    # rank 1's partial sums are replaced by zeros in the spp group's sums
    "dropped": """
    if ctx.rank == 1:
        import torch.distributed as dist
        orig = dist.all_reduce

        def dropped(x, op=dist.ReduceOp.SUM, group=None, async_op=False):
            if op == dist.ReduceOp.SUM and group is not ctx.ctl:
                x.zero_()
            return orig(x, op=op, group=group, async_op=async_op)
        dist.all_reduce = dropped
        try:
            return _planted(ctx, seed)
        finally:
            dist.all_reduce = orig
""",
    # no rank sums with the others: each keeps its own partial frame
    "no_exchange": """
    import torch.distributed as dist
    orig = dist.all_reduce

    def none(x, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if group is ctx.ctl:
            return orig(x, op=op, group=group, async_op=async_op)
    dist.all_reduce = none
    try:
        return _planted(ctx, seed)
    finally:
        dist.all_reduce = orig
""",
    # rank 2's copy of the frame differs from rank 0's in one word
    "disagree": """
    acc, res = _planted(ctx, seed)
    if ctx.rank == 2:
        import torch
        rad = acc[0].clone()
        rad.view(-1)[0] = torch.nextafter(rad.view(-1)[0],
                                          torch.tensor(float("inf")))
        acc = (rad, *acc[1:])
    return acc, res
""",
    "raises": """
    if ctx.rank == 2 and n == 1:
        raise RuntimeError("planted fault: rank 2 raises")
""",
    "dies": """
    if ctx.rank == 3 and n == 1:
        import signal
        os.kill(os.getpid(), signal.SIGKILL)
""",
    "rank0_raises": """
    if ctx.rank == 0 and n == 1:
        raise RuntimeError("planted fault: rank 0 raises")
""",
}


def plant(bench, kind):
    """Wrap the copy's sharded.frame with the fault `kind`."""
    with open(bench / "sharded.py", "a") as f:
        f.write("\n\n_planted, _calls = frame, [0]\n\n\n"
                "def frame(ctx, seed):\n"
                "    n = _calls[0]\n    _calls[0] += 1\n"
                + FAULTS[kind] + "    return _planted(ctx, seed)\n")


def test_sound_run_passes(tmp_path):
    root, _ = copy_sharded(tmp_path)
    rc, out, err, _ = rehearse(root)
    assert rc == 0, err[-4000:]
    assert out["correct"] is True, out
    check = {k: c["value"] for k, c in out["check"].items()}
    assert set(check) == {"radiance_gap", "z_gap", "samples_gap",
                          "image_gap", "rank_gap"}
    assert check["samples_gap"] == 0.0 and check["rank_gap"] == 0.0
    assert check["radiance_gap"] < 5e-5
    assert out["device"]["count"] == 4
    assert len(rank_pids(err)) == 3
    assert all(f"[rank {k}] " in err for k in (1, 2, 3))


@pytest.mark.parametrize("kind", ["dropped", "no_exchange", "disagree"])
def test_fault_fails(tmp_path, kind):
    root, bench = copy_sharded(tmp_path)
    plant(bench, kind)
    rc, out, err, _ = rehearse(root)
    assert out is not None, err[-4000:]
    assert out["correct"] is False, out["check"]
    assert out["failed"] == 1 and rc == 1
    gap = out["check"]["rank_gap"]["value"]
    if kind == "disagree":
        # rank 0's own frame is sound: only the ranks' agreement fails
        assert gap > 0
        assert all(c["value"] <= c["limit"] for k, c in out["check"].items()
                   if k != "rank_gap")
    elif kind == "dropped":
        assert gap == 0.0


@pytest.mark.parametrize("kind", ["raises", "dies", "rank0_raises"])
def test_failed_rank_ends_the_run(tmp_path, kind):
    root, bench = copy_sharded(tmp_path)
    plant(bench, kind)
    rc, out, err, seconds = rehearse(root)
    assert rc != 0 and out is None, err[-4000:]
    assert seconds < RUN_LIMIT_S
    pids = rank_pids(err)
    assert len(pids) == 3
    time.sleep(1.0)
    assert not [p for p in pids if alive(p)], err[-4000:]


SHARDED_READERS = ("scene_tables_ms_per_frame", "collective_ms_per_frame")
TRACE_READERS = {
    # the window's rtf.wave spans that rank 0's program recorded
    "t_waves": "len([s for s in P.spans(run) or [] if s[0] == P.WAVE])",
    # of those, waves that are not rank 0's (sample j on rank j % 4)
    "t_waves_elsewhere": "len([s for s in P.spans(run) or []"
                         " if s[0] == P.WAVE and s[6]['index'] % 4])",
    "t_frame_markers": "len([h for h in run.trace.host"
                       " if h[0] == devtrace.FRAME])",
}


def test_traced_run_reads_rank_0(tmp_path):
    """In-process rank 0 of a traced run: the program's spans are switched
    on around the window (nothing calls `render`), and the trace keeps the
    harness's window and frame markers."""
    root, bench = copy_sharded(tmp_path)
    m = manifest.load(root)
    for name, expr in TRACE_READERS.items():
        (bench / "metrics" / f"{name}.py").write_text(
            "from rtbench import devtrace\n"
            "from rtbench import program_trace as P\n\n\n"
            f"def read(run):\n    return float({expr})\n")
        m["per_layer"].append({"name": name, "unit": "n", "better": "lower",
                               "source": "program_span",
                               "layer": "frame loop", "moves": "frame_s",
                               "workloads": [CELL]})
    for name in SHARDED_READERS:
        m["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                               "source": "device_trace",
                               "layer": "frame loop", "moves": "frame_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out = harness.run(CELL, 5, 0.01, True, time.perf_counter(),
                      device="cpu", width=W, height=H, root=root,
                      bench_dir=bench)
    assert out["correct"] is True, out["check"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["t_waves"] == 2.0 * out["attempted"]
    assert got["t_waves_elsewhere"] == 0.0
    assert got["t_frame_markers"] == out["attempted"]
    assert "scene_build_s" in got and "device_idle_share" in got
    assert out["device"]["window_s"] > 0
    # render_sharded builds the tables every frame; no NCCL on the CPU
    assert got["scene_tables_ms_per_frame"] > 0
    assert "collective_ms_per_frame" not in got


def test_collective_reader():
    from rtbench import devtrace
    host = [(devtrace.WINDOW, 0.0, 1000.0)]
    dev = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
            "<4096ul>)", 100.0, 400.0), ("void wave_kernel<false>(Args)",
                                        400.0, 900.0),
           ("add", 900.0, 920.0),
           # c10d's annotation around the collective: no work of its own
           ("nccl:all_reduce", 90.0, 400.0)]
    run = harness.RunRecord({}, 2, {}, trace=devtrace.reduce(dev, host))
    assert run.trace.launches() == 3
    read = manifest.metric_reader("collective_ms_per_frame").read
    assert read(run) == 0.15
    ops = manifest.metric_reader("torch_ops_ms_per_frame").read
    assert ops(run) == pytest.approx(0.01)
    run.trace = devtrace.reduce(dev[1:], host)
    assert read(run) is None


def cell_of(tmp_path, chips, mesh):
    root, bench = copy_sharded(tmp_path)
    p = bench / "traffic" / "sharded4.json"
    t = json.loads(p.read_text())
    if mesh is None:
        t.pop("mesh")
    else:
        t["mesh"] = mesh
    p.write_text(json.dumps(t))
    m = manifest.load(root)
    next(w for w in m["workloads"] if w["name"] == CELL)["chips"] = chips
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, bench


@pytest.mark.parametrize("chips, mesh, size, words", [
    (4, None, (W, H), "names no mesh"),
    (4, {"tile": 2, "spp": 1}, (W, H), "2x1 mesh on 4 chips"),
    (4, {"tile": 4}, (W, H), "names no mesh"),
    (1, {"tile": 1, "spp": 1}, (W, H), "one chip"),
    (4, {"tile": 4, "spp": 1}, (W, H), "1024-lane blocks"),
    (4, {"tile": 2, "spp": 2}, (800, 600), "1024-lane blocks"),
])
def test_mesh_errors_before_set_up(tmp_path, monkeypatch, chips, mesh, size,
                                   words):
    root, bench = cell_of(tmp_path, chips, mesh)

    def no_set_up(*a, **k):
        raise AssertionError("set-up started")
    monkeypatch.setattr(harness, "build", no_set_up)
    monkeypatch.setattr(sharded, "Ranks", no_set_up)
    with pytest.raises(ValueError, match=words) as e:
        harness.run(CELL, 1, 0.01, False, time.perf_counter(), device="cpu",
                    width=size[0], height=size[1], root=root,
                    bench_dir=bench)
    assert CELL in str(e.value)


@pytest.mark.parametrize("chips, mesh, size, want", [
    (4, {"tile": 1, "spp": 4}, (W, H), (1, 4)),
    (4, {"tile": 4, "spp": 1}, (64, 64), (4, 1)),
    (2, {"tile": 2, "spp": 1}, (800, 600), None),
])
def test_mesh_of(tmp_path, chips, mesh, size, want):
    root, bench = cell_of(tmp_path, chips, mesh)
    cell = manifest.Cell(manifest.load(root), CELL, root, bench)
    if want is None:             # 240,000 lanes a tile: not whole blocks
        with pytest.raises(ValueError):
            sharded.mesh_of(cell, *size)
    else:
        assert sharded.mesh_of(cell, *size) == want
    one = manifest.Cell(manifest.load(root), "ball.fused_64spp", root, bench)
    assert sharded.mesh_of(one) is None
