"""The port's profiling tools (``utils.profiling``) on the CPU.

- ``format_roofline`` prints the reference's text, byte for byte, for the same
  ``(peaks, rows)``.
- ``roofline`` on a small Chrome trace written here (an H100's kernels, the
  profiler's operator events with their FLOPs) groups the device events into
  the expected rows, an operator's FLOPs shared by its (GEMM) kernels by time; it raises
  ``FileNotFoundError`` on a directory without a trace and ``ValueError`` on a
  trace without device events, as the reference does for a missing TPU plane.
- ``trace`` writes a Chrome trace of the CPU's operators with their FLOPs;
  ``profile_steps`` returns the last result.
"""

import json

import numpy as np
import pytest
import torch

from dmlcloud_tpu.utils import profiling as jprof
from dmlcloud_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


@pytest.mark.parametrize("min_frac", [0.001, 0.2])
def test_format_roofline_is_the_references_text(min_frac):
    rng = np.random.RandomState(0)
    peaks = {"device": "NVIDIA H100 80GB HBM3", "peak_tflops": 989.4, "peak_hbm_gbps": 3350.0}
    rows = [{"category": c, "time_frac": float(f), "ms_per_step": float(ms), "tflops": float(tf),
             "gbps": float(gb), "n_per_step": int(n)}
            for c, f, ms, tf, gb, n in zip(["gemm", "flash_fwd_tc", "triton fused", "copy/cast"],
                                           rng.dirichlet(np.ones(4)), rng.rand(4) * 100, rng.rand(4) * 500,
                                           rng.rand(4) * 3000, rng.randint(1, 500, 4))]
    assert tprof.format_roofline(peaks, rows, min_frac) == jprof.format_roofline(peaks, rows, min_frac)
    unknown = dict(peaks, device="?", peak_tflops=0.0, peak_hbm_gbps=0.0)
    assert tprof.format_roofline(unknown, rows) == jprof.format_roofline(unknown, rows)
    assert tprof.format_roofline(peaks, []) == jprof.format_roofline(peaks, [])


def _kernel(name, dur, ext, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0.0, "dur": dur,
            "args": {"External id": ext, "device": 0}}


def _write_trace(path, events, name="NVIDIA H100 80GB HBM3"):
    doc = {"deviceProperties": [{"id": 0, "name": name}], "traceEvents": events}
    path.write_text(json.dumps(doc))


def test_roofline_groups_device_kernels_and_credits_operator_flops(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5, "args": {"External id": 1, "flops": 2e9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 0, "dur": 5, "args": {"External id": 5, "flops": 1e9}},
        {"ph": "X", "cat": "cpu_op", "name": "dmlcloud_tpu_torch::flash_fwd", "ts": 0, "dur": 5,
         "args": {"External id": 2, "flops": 0}},
        # two steps of: one GEMM (two kernels of one operator), K1, an Inductor
        # kernel, a reduction, a copy and a NCCL all-reduce
        *[e for _ in range(2) for e in (
            _kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 1000.0, 1),
            _kernel("cublasLt::splitKreduce_kernel", 100.0, 1),
            _kernel("void flash_fwd_tc_kernel<128>(CUtensorMap_st, float*, int)", 200.0, 2),
            _kernel("triton_poi_fused__to_copy_mul_rsqrt_0", 300.0, 3),
            _kernel("void at::native::reduce_kernel<512, 1>(...)", 50.0, 4),
            _kernel("Memcpy HtoD (Pinned -> Device)", 40.0, 5, cat="gpu_memcpy"),
            _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 60.0, 6),
            _kernel("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>", 10.0, 7),
        )],
    ]
    _write_trace(tmp_path / "trace.json", events)
    peaks, rows = tprof.roofline(str(tmp_path), steps=2)
    assert peaks == {"device": "NVIDIA H100 80GB HBM3", "peak_tflops": 989.4, "peak_hbm_gbps": 3350.0}
    by = {r["category"]: r for r in rows}
    assert [r["category"] for r in rows] == ["gemm", "triton fused", "flash_fwd_tc", "nccl", "reduction", "copy/cast",
                                             "elementwise/other"]
    assert set(rows[0]) == {"category", "time_frac", "ms_per_step", "tflops", "gbps", "n_per_step"}
    total_us = 2 * (1000 + 100 + 200 + 300 + 50 + 40 + 60 + 10)
    assert by["gemm"]["n_per_step"] == 2 and by["gemm"]["ms_per_step"] == pytest.approx(1.1)
    assert by["gemm"]["time_frac"] == pytest.approx(2200 / total_us)
    # the operator's 2e9 FLOPs shared by its four kernels (both steps' GEMM and
    # split-K reduction, one category here) in proportion to their time
    assert by["gemm"]["tflops"] == pytest.approx(2e9 / 2200 / 1e6)
    assert by["flash_fwd_tc"]["n_per_step"] == 1 and by["flash_fwd_tc"]["tflops"] == 0.0
    # an operator that launched no GEMM kernel (here only a copy) keeps its FLOPs on its kernels
    assert by["copy/cast"]["tflops"] == pytest.approx(1e9 / 80 / 1e6)
    assert all(r["gbps"] == 0.0 for r in rows)
    assert sum(r["time_frac"] for r in rows) == pytest.approx(1.0)
    text = tprof.format_roofline(peaks, rows)
    assert text.splitlines()[0] == "device: NVIDIA H100 80GB HBM3  peak 989 TF/s, HBM 3350 GB/s"


def test_roofline_raises_as_the_reference_does(tmp_path):
    with pytest.raises(FileNotFoundError):
        tprof.roofline(str(tmp_path))
    _write_trace(tmp_path / "trace.json", [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1,
                                             "args": {"External id": 1}}], name="?")
    with pytest.raises(ValueError, match="no device kernel events"):
        tprof.roofline(str(tmp_path))


def test_trace_and_profile_steps_on_the_cpu(tmp_path):
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    calls = []

    def step(x):
        calls.append(1)
        return x @ b

    out = tprof.profile_steps(step, 3, str(tmp_path), a)
    assert len(calls) == 3 and torch.equal(out, a @ b)
    doc = json.loads((tmp_path / tprof.TRACE_FILE).read_text())
    mms = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    assert len(mms) == 3 and all(e["args"]["flops"] == 2 * 16 * 32 * 8 for e in mms)
    with pytest.raises(ValueError, match="no device kernel events"):
        tprof.roofline(str(tmp_path))
    with tprof.trace(str(tmp_path / "again")) as prof:
        torch.relu(a)
    assert prof is not None and (tmp_path / "again" / tprof.TRACE_FILE).is_file()
