"""The metric arithmetic on synthetic event times and traces."""

import pytest

from portbench import spec, stats, trace
from portbench.harness import Run


def _trace(kernels, start, end, steps=2, host=()):
    return trace.Trace(list(kernels), list(host), start, end, steps)


def test_p90_rate_and_gaps():
    assert stats.p90(list(range(1, 11))) == pytest.approx(9.1)
    assert stats.p90([5.0]) == 5.0
    assert stats.rate(512, 2.0) == 256.0
    assert stats.gaps_ms([0.0, 10.0, 25.0, 45.0]) == [10.0, 15.0, 20.0]


def test_busy_idle_and_classes_on_a_synthetic_trace():
    k = [("sm90_xmma_fprop_conv", 0.0, 40.0),
         ("elementwise_kernel_mul", 30.0, 20.0),     # overlaps the first
         ("sgd_chunk", 60.0, 10.0),
         ("ncclAllReduce", 90.0, 30.0)]              # runs past the window
    tr = _trace(k, 0.0, 100.0)
    assert trace.busy_intervals(tr) == [(0.0, 50.0), (60.0, 70.0),
                                        (90.0, 100.0)]
    assert trace.busy_s(tr) == pytest.approx(70e-6)
    assert trace.idle_gaps(tr) == [(50.0, 60.0), (70.0, 90.0)]
    cls = trace.class_us(tr)
    assert cls == {"gemm/convolution": 40.0, trace.OTHER: 20.0,
                   "B1 fused_sgd": 10.0, "nccl": 10.0}
    assert trace.name_us(tr, lambda n: "sgd_chunk" in n) == 10.0


def test_breakdown_names_the_host_call_at_each_gap():
    k = [("a", 0.0, 10.0), ("b", 20.0, 10.0), ("a", 50.0, 10.0)]
    host = [("cudaStreamSynchronize", 8.0, 14.0),
            ("cudaLaunchKernel", 40.0, 2.0)]
    bd = trace.breakdown(_trace(k, 0.0, 60.0, host=host))
    assert [n for n, _ in bd["device_ops"]] == ["a", "b"]
    assert [v for _, v in bd["device_ops"]] == pytest.approx([20e-6, 10e-6])
    assert [n for n, _ in bd["idle_gaps"]] == ["host between calls",
                                               "cudaStreamSynchronize"]
    assert [v for _, v in bd["idle_gaps"]] == pytest.approx([20e-6, 10e-6])


def test_load_takes_the_device_events_and_their_window(tmp_path):
    import json
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 5},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 110,
           "dur": 5},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 95, "dur": 2},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.load(str(p), 3)
    assert (tr.start, tr.end, tr.steps) == (100.0, 115.0, 3)
    assert [n for n, _, _ in tr.kernels] == ["k1", "Memcpy"]
    assert tr.host == [("cudaLaunchKernel", 95.0, 2.0)]


def _run(**kw):
    cfg = {"compute_dtype": "bfloat16"}
    run = Run(cfg, {"batch": 256}, params=1_000_000,
              flops_per_sample=24.5e9)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _read(name, run):
    return spec.metric_module(name).read(run)


def test_end_to_end_readers():
    run = _run(steps=10, samples=2560, window_s=2.0, setup_s=12.5,
               step_ms=[200.0] * 9 + [300.0], memory_peak_bytes=3 * 2**30)
    assert _read("train_samples_per_s", run) == 1280.0
    assert _read("step_ms_p90", run) == pytest.approx(210.0)
    assert _read("peak_mem_gib", run) == 3.0
    assert _read("setup_s", run) == 12.5


def test_per_layer_readers():
    k = [("sm90_xmma_fprop", 0.0, 4000.0), ("elementwise_kernel", 4000.0,
                                            12000.0),
         ("sgd_chunk", 16000.0, 3.5822)]
    tr = _trace(k, 0.0, 20000.0, steps=2)
    run = _run(steps=10, samples=2560, window_s=2.0, trace=tr,
               dispatch=(0.5, 10), data_wait_s=[0.001, 0.003])
    assert _read("dispatch_ms", run) == pytest.approx(50.0)
    assert _read("data_wait_ms", run) == pytest.approx(2.0)
    assert _read("conv_gemm_ms", run) == pytest.approx(2.0)
    assert _read("norm_eltwise_ms", run) == pytest.approx(6.0)
    # 12 MB at 3.35 TB/s is 3.5821 us; B1 took 3.5822 us over 2 steps
    assert _read("b1_roofline", run) == pytest.approx(
        100 * 12e6 / 3.35e12 / (3.5822e-6 / 2))
    assert _read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 16003.5822 / 20000))
    assert _read("mfu_pct", run) == pytest.approx(
        100 * 24.5e9 * 2560 / 2.0 / 989e12)


def test_readers_with_nothing_to_read_return_nothing():
    tr = _trace([("elementwise_kernel", 0.0, 10.0)], 0.0, 10.0)
    run = _run(trace=tr, dispatch=(0.0, 0), data_wait_s=[])
    for name in ("dispatch_ms", "data_wait_ms", "conv_gemm_ms",
                 "b1_roofline"):
        assert _read(name, run) is None
