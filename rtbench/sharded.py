"""A cell on N > 1 cards: one process per card through the program's
sharded entry, `parallel/mesh.py::render_sharded`, as a sharded user runs it.

The cell's traffic names the mesh, `"mesh": {"tile": t, "spp": s}` with
t * s the cell's chips (`mesh_of`).  Rank 0 is the process the benchmark
starts (rtbench/run.py, or rtbench/rehearse.py with gloo ranks on the
CPU).  It starts ranks 1..N-1 as fresh processes of rtbench/run.py
(`--rank k --port p --parent <pid>`, `Ranks`), whose output comes through
on its standard error prefixed `[rank k]`.  Every rank joins the group
through `parallel/distributed.py::init_multihost` (NCCL on the cards, gloo
on the CPU), builds the mesh with `make_mesh(t, s)` and its own replicated
scene, and runs the same frames: the warm-up, then the window.  A frame is
`render_sharded` on every rank and `finalize` on rank 0, whose copy to the
host ends it.  Rank 0 decides when the window closes, by the rule of
harness.py::window, and sends continue or stop before each frame over a
gloo group of its own, so the device trace holds no collective of the
harness.

After the window rank 0 keeps the frame that reservoir sampling chose (the
one-card path's draw), and every rank compares its own copy of that
frame's accumulators with rank 0's, bit for bit (`rank_gap`, the share of
words that differ; limit 0).  A rank that raises or dies, or a run past
its deadline, ends the run with a non-zero exit and no result line; rank 0
kills the other ranks, and a rank whose rank 0 is gone is killed by the
kernel (PR_SET_PDEATHSIG).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import faulthandler
import gc
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from rtbench import devtrace, harness, program_trace

BLOCK = 1024              # the wave kernel's lanes a random-stream block
SETUP_LIMIT_S = 1100      # set-up, a checkout's first build included
AFTER_WINDOW_S = 240      # the window's last frame, the exchange, the check
GRACE_S = 20              # for rank 0 to fail by itself once a rank is gone
CTL_TIMEOUT_S = 300       # the control group's wait for any one message


def mesh_of(cell, width=None, height=None):
    """(tile, spp) of a cell on several cards, None on one; raises
    ValueError, naming the cell, where the mesh and the chips disagree or
    a tile's lanes are not whole 1024-lane blocks (the check's random
    streams would not be the single-card frame's)."""
    mesh = cell.traffic.get("mesh")
    if cell.chips == 1:
        if mesh is not None:
            raise ValueError(f"{cell.name}: one chip, and its traffic names "
                             f"the mesh {mesh}")
        return None
    if not isinstance(mesh, dict) or set(mesh) != {"tile", "spp"}:
        raise ValueError(f"{cell.name}: {cell.chips} chips, and its traffic "
                         f"names no mesh {{\"tile\": t, \"spp\": s}}")
    tile, spp = int(mesh["tile"]), int(mesh["spp"])
    if tile < 1 or spp < 1 or tile * spp != cell.chips:
        raise ValueError(f"{cell.name}: a {tile}x{spp} mesh on "
                         f"{cell.chips} chips")
    args = cell.config["args"]
    w = args["width"] if width is None else width
    h = args["height"] if height is None else height
    if tile > 1 and (w * h) % (tile * BLOCK):
        raise ValueError(f"{cell.name}: {w}x{h} in {tile} tiles is not "
                         f"whole {BLOCK}-lane blocks a tile")
    return tile, spp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def guard_child(parent: int, limit_s: float):
    """In a rank > 0: die with rank 0 (the kernel sends SIGKILL when the
    parent goes) and at the latest after limit_s."""
    if sys.platform.startswith("linux"):
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        raise SystemExit(f"[rtbench] rank 0 (pid {parent}) is gone")
    faulthandler.dump_traceback_later(limit_s, exit=True)


class Ranks:
    """Ranks 1..N-1 of a run, started by rank 0, with a watchdog: a rank
    that exits non-zero, or the deadline passing, kills every rank left;
    where rank 0 has not failed by itself GRACE_S later (a collective may
    wait for the dead rank), it ends rank 0's process."""

    def __init__(self, argv_of, world: int, env: dict):
        self.deadline = time.monotonic() + SETUP_LIMIT_S
        self.failure = None
        self._done = threading.Event()
        self.procs, self._pumps = {}, []
        try:
            for k in range(1, world):
                p = subprocess.Popen(
                    argv_of(k), env=env, stdin=subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, errors="replace")
                self.procs[k] = p
                print(f"[rtbench] rank {k}: pid {p.pid}", file=sys.stderr,
                      flush=True)
                t = threading.Thread(target=_pump, args=(k, p.stdout),
                                     daemon=True)
                t.start()
                self._pumps.append(t)
        except BaseException:
            self.kill()
            raise
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def window_started(self, seconds: float):
        self.deadline = time.monotonic() + seconds + AFTER_WINDOW_S

    def _watchdog(self):
        while not self._done.wait(0.2):
            bad = {k: p.returncode for k, p in self.procs.items()
                   if p.poll() not in (None, 0)}
            if bad:
                self.failure = f"ranks exited with {bad}"
            elif time.monotonic() > self.deadline:
                self.failure = "the run passed its deadline"
            else:
                continue
            print(f"[rtbench] {self.failure}: ending every rank",
                  file=sys.stderr, flush=True)
            self.kill()
            if not self._done.wait(GRACE_S):
                sys.stderr.flush()
                os._exit(1)
            return

    def kill(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()

    def finish(self, timeout: float):
        """Wait for every rank to end; raises unless all exited 0."""
        end = time.monotonic() + timeout
        try:
            for p in self.procs.values():
                p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.failure = self.failure or "a rank did not end"
        self.close()
        bad = {k: p.returncode for k, p in self.procs.items()
               if p.returncode != 0}
        if bad or self.failure:
            raise RuntimeError(f"ranks failed: {self.failure or bad}")

    def close(self):
        """Stop the watchdog, kill what is left and take the output."""
        self._done.set()
        self.kill()
        for t in self._pumps:
            t.join(timeout=10)


def _pump(rank: int, stream):
    for line in stream:
        sys.stderr.write(f"[rank {rank}] {line}")
    sys.stderr.flush()


@dataclasses.dataclass
class Rank:
    """What one rank's frames take."""
    rank: int
    scene: object
    tables: object
    cfg: object
    mesh: object
    dev: object
    ctl: object                  # the harness's gloo group


def frame(ctx: Rank, seed: int):
    """One frame as a sharded user renders it: (the accumulators in pixel
    order on this rank, rank 0's RenderResult or None)."""
    from rtf_tpu_torch.parallel.mesh import render_sharded
    from rtf_tpu_torch.render.renderer import finalize
    acc = render_sharded(ctx.scene, ctx.cfg, ctx.mesh, seed=seed,
                         device=ctx.dev)
    res = finalize(ctx.scene, ctx.cfg, ctx.tables, *acc) \
        if ctx.rank == 0 else None
    return acc, res


def window(ctx: Rank, seed, seconds, keep_seed):
    """harness.py::window over every rank: rank 0 sends (continue, keep)
    before each frame, and stop once `seconds` have passed at a frame's
    end.  Returns (start, end, frame times, kept) with kept (index, seed,
    accumulators, rank 0's result)."""
    import torch
    from torch import distributed as dist
    from torch.autograd import profiler
    rng = np.random.default_rng(keep_seed)
    msg = torch.zeros(2, dtype=torch.int64)
    times, kept, end = [], None, None
    span = profiler.record_function(devtrace.WINDOW)
    start = time.perf_counter()
    span.__enter__()
    try:
        while True:
            i = len(times)
            if ctx.rank == 0:
                go = i == 0 or end - start < seconds
                msg[0] = int(go)
                msg[1] = int(go and rng.random() * (i + 1) < 1.0)
                if not go:
                    span.__exit__(None, None, None)
                    span = None
            dist.broadcast(msg, 0, group=ctx.ctl)
            if not msg[0]:
                break
            s = harness.frame_seed(seed, i)
            t = time.perf_counter()
            with profiler.record_function(devtrace.FRAME):
                acc, res = frame(ctx, s)
            end = time.perf_counter()
            times.append(end - t)
            if msg[1]:
                kept = (i, s, acc, res)
    finally:
        if span is not None:
            span.__exit__(None, None, None)
    return start, end, times, kept


def agreement(ctx: Rank, acc, world: int) -> float:
    """The share of the kept frame's words (rad, hits, z, nsamples) that
    differ from rank 0's copy, over ranks 1..N-1 (0.0 on rank 0 alone;
    every rank calls it)."""
    import torch
    from torch import distributed as dist
    mine = torch.cat([x.detach().contiguous().view(torch.int32).reshape(-1)
                      .cpu() for x in acc])
    ref = mine.clone() if ctx.rank == 0 else torch.empty_like(mine)
    dist.broadcast(ref, 0, group=ctx.ctl)
    diff = torch.tensor([int((mine != ref).sum())], dtype=torch.int64)
    dist.all_reduce(diff, group=ctx.ctl)
    return int(diff) / ((world - 1) * mine.numel())


def run(cell, tile, spp, workload, seed, seconds, trace, t0, device,
        width, height, bench_dir, rank, port, parent):
    """One rank's part of a run; rank 0 returns the result line's object
    (harness.run's), the others None."""
    import torch
    from torch import distributed as dist

    from rtf_tpu_torch.parallel.distributed import init_multihost
    from rtf_tpu_torch.parallel.mesh import make_mesh
    world = cell.chips
    ranks = None
    if rank == 0:
        port = free_port()
        ranks = Ranks(lambda k: _argv(bench_dir, workload, seed, seconds,
                                      trace, device, width, height, k,
                                      port),
                      world, _env())
    else:
        guard_child(parent, SETUP_LIMIT_S + seconds + AFTER_WINDOW_S)
        if device == "cpu":
            torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1)
                                             // world)))
    try:
        init_multihost(f"localhost:{port}", world, rank, device=device)
        ctl = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=CTL_TIMEOUT_S))
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device == "cuda" else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        mesh = make_mesh(tile, spp, device_type=dev.type)
        out = _frames(cell, workload, seed, seconds, trace, t0, dev, width,
                      height, bench_dir, rank, world, mesh, ctl, ranks)
        dist.destroy_process_group()
        if ranks is None:
            return None
        ranks.finish(timeout=60)
        return out
    except BaseException:
        if ranks is not None:
            ranks.close()
        raise


def _frames(cell, workload, seed, seconds, trace, t0, dev, width, height,
            bench_dir, rank, world, mesh, ctl, ranks):
    import torch
    from torch import distributed as dist
    cfg = harness.render_config(cell.traffic)
    readers = harness.load_readers(cell, bench_dir) if trace else {}
    with torch.no_grad():
        spans, scene, tables = harness.set_up(cell, dev, width, height)
        ctx = Rank(rank, scene, tables, cfg, mesh, dev, ctl)
        frame(ctx, harness.frame_seed(seed, -1))
        harness._sync(dev)
        dist.barrier(group=ctl)

        tr = program_trace._tracing() if trace else None
        wrapped = harness._Wrapped(readers.values()) if trace else None
        prof = devtrace.Recorder(dev.type == "cuda") if trace \
            else contextlib.nullcontext()
        if ranks is not None:
            ranks.window_started(seconds)
        try:
            if tr is not None:
                tr.collect()
                tr.enable()
            with prof:
                start, end, times, kept = window(
                    ctx, seed, seconds, harness.derived_seed(seed, 3))
            harness._sync(dev)
        finally:
            program = None
            if tr is not None:
                program = tr.collect()
                tr.disable()
            if wrapped is not None:
                wrapped.restore()
    setup_s = start - t0
    index, kseed, acc, result = kept
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0], dtype=torch.int64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=ctl)
    rank_gap = agreement(ctx, acc, world)
    if rank != 0:
        return None
    harness.refuse_forbidden()
    record = harness.RunRecord(spans=spans, frames=len(times),
                               facts=harness.scene_facts(scene, tables))
    if trace:
        record.trace = prof.trace()
        record.calls = wrapped.calls
        record.program = program

    # the check: the program's state freed, the reference on the kept frame
    program = {k: getattr(result, k) for k in
               ("image", "radiance", "z", "sample_count")}
    del scene, tables, result, acc, ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, compared, ref_s = harness.verify(cell, seed, kseed, program, dev,
                                         width, height)
    compared["rank_gap"] = {"value": rank_gap, "limit": 0.0}
    ok = ok and rank_gap == 0.0
    return harness.result(cell, workload, seed, ok, compared, record,
                          readers, trace, start, end, times, setup_s, dev,
                          int(peak), index, ref_s)


def _argv(bench_dir: Path, workload, seed, seconds, trace, device, width,
          height, rank, port) -> list:
    argv = [sys.executable, str(Path(bench_dir) / "run.py"), "--workload",
            workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(int(trace)), "--device", device, "--rank",
            str(rank), "--port", str(port), "--parent", str(os.getpid())]
    if width is not None:
        argv += ["--width", str(width), "--height", str(height)]
    return argv


def _env() -> dict:
    """This process's environment, with the program's package importable
    wherever the benchmark's copy lies."""
    env = dict(os.environ)
    pkg = str(devtrace.program_dir().parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env
