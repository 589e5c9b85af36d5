"""launches_per_frame: kernels launched on the card in the traced window
over the frames completed (torch.profiler; copies and sets left out).  A
count that repeats where the frame's work does.  Moves frame_s."""


def read(run):
    if run.trace is None or run.frames < 1:
        return None
    n = run.trace.launches()
    return n / run.frames if n else None
