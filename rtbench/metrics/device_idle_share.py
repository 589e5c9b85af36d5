"""device_idle_share (%): the share of the traced window in which no
kernel, copy or set ran on the card (1 - the union of the device events'
intervals over the window, torch.profiler).  Moves frame_s."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
