"""wave_ms_per_launch (ms): the device milliseconds of one wave launch in
the traced window: the kernels named wave_kernel and, on the MXU tables,
the block_order pass that each launch runs before its kernel
(rtf_tpu_torch/csrc/wave_kernel.cu), over the count of wave_kernel
launches.  A program without block_order reads its wave kernel alone.
Moves frame_s."""

KERNELS = ("wave_kernel", "block_order")


def read(run):
    if run.trace is None:
        return None
    us, launches = run.trace.kernel_us(KERNELS[0])
    if not launches:
        return None
    us += sum(run.trace.kernel_us(k)[0] for k in KERNELS[1:])
    return us / 1e3 / launches
