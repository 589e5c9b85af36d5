"""wave_ms_per_launch on synthetic traces: the wave kernel's launches with
and without the block_order pass before each, and none without a wave."""
import pytest

from rtbench import devtrace, harness, manifest

HOST = [(devtrace.WINDOW, 0.0, 1000.0)]
KERNEL = "void (anonymous namespace)::wave_kernel<false, false, true, false>"
ORDER = "(anonymous namespace)::block_order((anonymous namespace)::Args, int*)"


def read(device):
    run = harness.RunRecord(spans={}, frames=1, facts={},
                            trace=devtrace.reduce(device, HOST))
    return manifest.metric_reader("wave_ms_per_launch").read(run)


@pytest.mark.parametrize("order_us", [None, 5.0])
def test_counts_the_order_pass(order_us):
    dev = [(KERNEL, 100.0, 300.0), ("add", 320.0, 330.0),
           (KERNEL, 400.0, 500.0)]
    if order_us is not None:
        dev += [(ORDER, 90.0, 90.0 + order_us),
                (ORDER, 390.0, 390.0 + order_us)]
    extra = 0.0 if order_us is None else 2 * order_us
    assert read(dev) == pytest.approx((300.0 + extra) / 2 / 1e3)


def test_none_without_a_wave():
    assert read([("add", 320.0, 330.0)]) is None
    run = harness.RunRecord(spans={}, frames=1, facts={}, trace=None)
    assert manifest.metric_reader("wave_ms_per_launch").read(run) is None


def test_declared():
    m = {e["name"]: e for e in manifest.load()["per_layer"]}
    e = m["wave_ms_per_launch"]
    assert (e["layer"], e["moves"], e["source"], e["workloads"]) == (
        "wave kernel", "frame_s", "device_trace", ["ball.fused_64spp"])
