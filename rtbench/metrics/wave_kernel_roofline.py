"""wave_kernel_roofline (%): the wave kernel's least time over its device
time in the traced window.  The least time is the bytes of each launch
(rtbench/roofline.py::wave_bytes: each lane's ray, and a child wave's
state, in; its radiance, hit and z, and the rows asked for, out; the scene
once) over 3.35 TB/s, summed over the launches; a bytes-only bound.  Each
launch's lanes come from rtf_tpu_torch/render/wave.py::wave, wrapped in the
traced run; the device time is that of the kernels named wave_kernel.
Moves frame_s."""

from rtbench import roofline

ENTRY = "rtf_tpu_torch.render.wave:wave"
KERNEL = "wave_kernel"
_ARGS = ("cfg", "tables", "o3", "d3", "alive", "seed", "bounces", "blk0",
         "tput3", "absorb3", "rtype", "surf_out", "gi_from", "stats")


def record(a, k):
    """(lanes, child state, surface rows, GI bounces) of one call."""
    arg = dict(zip(_ARGS, a), **k)
    nb = (arg["cfg"].bounces if arg.get("bounces") is None
          else arg["bounces"]) + 1
    gi_from = arg.get("gi_from")
    state = any(arg.get(n) is not None for n in ("tput3", "absorb3",
                                                 "rtype"))
    return (int(arg["o3"].shape[1]), state, bool(arg.get("surf_out")),
            0 if gi_from is None else max(0, nb - gi_from))


def read(run):
    if run.trace is None or not run.calls:
        return None
    least = sum(roofline.least_seconds(roofline.wave_bytes(
        n, state, surf, gi, run.facts))
        for n, state, surf, gi in run.calls.get(ENTRY, []))
    us, _ = run.trace.kernel_us(KERNEL)
    return roofline.share(least, us / 1e6)
