"""scene_tables_ms_per_frame (ms): host milliseconds a frame inside the
program's `scene_tables` in the window (wrapped by the harness, each call a
host span on the profiler's timeline).  `render_sharded` gives `_prepare`
no tables, so a sharded frame builds the scene's tables anew on every
rank; a one-card frame reuses set-up's and records none (None).  Moves
frame_s."""

ENTRY = "rtf_tpu_torch.render.scene_tables:scene_tables"
NAME = f"rtbench.launch:{ENTRY}"


def record(a, k):
    return None


def read(run):
    if run.trace is None or not (run.calls or {}).get(ENTRY) \
            or run.frames < 1:
        return None
    w0, w1 = run.trace.window
    us = sum(min(e, w1) - max(s, w0) for n, s, e in run.trace.host
             if n == NAME and e > w0 and s < w1)
    return us / 1e3 / run.frames if us else None
