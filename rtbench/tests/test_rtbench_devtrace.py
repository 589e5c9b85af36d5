"""The trace's reduction on synthetic events."""
import pytest

from rtbench import devtrace

HOST = [(devtrace.WINDOW, 0.0, 100.0), ("aten::nonzero", 30.0, 70.0),
        ("aten::add", 35.0, 36.0), ("outer", 0.0, 100.0)]
DEV = [("wave_kernel<false>", 10.0, 20.0), ("add_kernel", 15.0, 25.0),
       ("Memcpy DtoH (Device -> Pageable)", 80.0, 90.0),
       ("before", -10.0, 5.0)]


def test_union_and_gaps():
    tr = devtrace.reduce(DEV, HOST)
    # busy: [0, 5] (clipped), [10, 25], [80, 90]
    assert tr.busy_us == pytest.approx(5 + 15 + 10)
    assert tr.gaps == [(5.0, 10.0), (25.0, 80.0), (90.0, 100.0)]
    assert tr.window_us == 100.0
    assert tr.launches() == 3
    assert tr.kernel_us("wave_kernel") == (10.0, 1)


def test_breakdown_names_gaps_by_innermost_host_op():
    b = devtrace.breakdown(devtrace.reduce(DEV, HOST))
    assert b["idle_gaps"][0] == ["aten::nonzero", pytest.approx(55e-6)]
    assert b["device_ops"][0][0] in ("wave_kernel<false>", "add_kernel",
                                     "Memcpy DtoH (Device -> Pageable)")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_one_window_span():
    with pytest.raises(RuntimeError):
        devtrace.reduce(DEV, HOST[1:])


def test_own_kernels_are_read_from_the_program_sources():
    """Every __global__ function of the program's CUDA sources, found
    anew from the files (a later kernel counts without an edit here)."""
    import re
    pkg = devtrace.program_dir()
    found = devtrace.own_kernels(pkg)
    declared = sum(len(re.findall(r"__global__", p.read_text()))
                   for p in pkg.rglob("*") if p.suffix in (".cu", ".cuh"))
    assert len(found) == declared
    assert {"wave_kernel", "mesh_hit_kernel", "mesh_hit_mxu_kernel",
            "bvh_hit_kernel", "bvh_wide_kernel"} <= set(found)


def test_own_kernels_find_new_cuda_and_triton_kernels(tmp_path):
    (tmp_path / "a.cu").write_text(
        "template <bool X>\n__global__ void __launch_bounds__(128, 2)\n"
        "new_walk(const float* a) {}\n__global__ void plain_k(int n) {}\n")
    (tmp_path / "b.py").write_text(
        "import triton\n\n\n@triton.jit\ndef fused_shade(x_ptr):\n    pass\n")
    assert devtrace.own_kernels(tmp_path) == ("fused_shade", "new_walk",
                                              "plain_k")


def test_kernel_matcher_takes_whole_identifiers():
    own = devtrace.kernel_matcher(("wave_kernel",))
    assert own.search("void wave_kernel<false, true>(Args)")
    assert not own.search("void my_wave_kernel_2(float*)")
    assert not own.search("at::native::vectorized_elementwise_kernel<4>")
    assert not devtrace.kernel_matcher(()).search("wave_kernel")
