"""The port's spans inside the SGD step and the device feed, its counts
at the collectives, and the benchmark's readers of both
(``portbench/spans.py`` and its metrics):

* a step of ``build_sgd_step`` is one trace: a root ``train.step{step=sgd}``
  whose duration the dispatch histogram observes, with ``train.forward``,
  ``train.backward``, ``train.grad_sum`` and ``train.update`` as its
  children; a scanned step records the root alone;
* ``DeviceDataset.gather`` records ``data.gather``;
* ``collective_calls_total`` and ``collective_bytes_total`` count what the
  step issues: ResNet-50's 53 sync batchnorms twice, its 8 gradient buckets
  at 16 MiB and the loss, each at its buffer's bytes; a graphed program
  counts them once a replay;
* with telemetry off nothing is recorded;
* a span's ``start`` lies on the profiler trace's clock;
* the readers' arithmetic on a synthetic run and trace.

One gloo rank on the CPU, ResNet-50 at 32 px, batch 2.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distlearn_tpu_torch import obs  # noqa: E402
from distlearn_tpu_torch.data import DeviceDataset  # noqa: E402
from distlearn_tpu_torch.models import resnet50  # noqa: E402
from distlearn_tpu_torch.ops import flatten as flatten_lib  # noqa: E402
from distlearn_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from distlearn_tpu_torch.parallel.mesh import MeshTree, init_mesh  # noqa: E402
from distlearn_tpu_torch.train import graphs  # noqa: E402
from distlearn_tpu_torch.train import trainer as ttr  # noqa: E402
from portbench import harness, spans, spec, trace  # noqa: E402

PHASES = ("train.forward", "train.backward", "train.grad_sum",
          "train.update")
BUCKET_BYTES = 16 * 2**20
LR, SIZE, BATCH = 0.1, 32, 2


@pytest.fixture(scope="module")
def tree():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    mesh = init_mesh(store=dist.HashStore(), device="cpu")
    yield mesh
    dist.destroy_process_group()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return resnet50(num_classes=1000, image_size=SIZE)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
            rs.randint(0, 1000, BATCH).astype(np.int32))


_counts = spans.counter
_dispatch = harness._dispatch_totals


def _new_records(fn):
    """The span records ``fn()`` leaves in the (emptied) ring."""
    obs.trace.clear()
    fn()
    return obs.trace.spans()


@pytest.fixture(scope="module")
def sgd_step(tree, model):
    """One step's records, its counter and histogram deltas, and the step's
    state before it."""
    ts = ttr.init_train_state(model, tree, 0, 1000)
    step = ttr.build_sgd_step(model, tree, LR, fused=True,
                              max_bucket_bytes=BUCKET_BYTES)
    x, y = _batch()
    calls0, bytes0 = (_counts("collective_calls_total"),
                      _counts("collective_bytes_total"))
    h0 = _dispatch()
    recs = _new_records(lambda: step(ts, x, y))
    h1 = _dispatch()
    delta = lambda a, b: {k: v - a.get(k, 0) for k, v in b.items()}  # noqa
    return {"recs": recs, "ts": ts,
            "calls": delta(calls0, _counts("collective_calls_total")),
            "bytes": delta(bytes0, _counts("collective_bytes_total")),
            "hist": (h1[0] - h0[0], h1[1] - h0[1])}


def test_sgd_step_is_one_trace_of_four_phases(sgd_step):
    recs = sgd_step["recs"]
    (root,) = [r for r in recs if r["name"] == "train.step"]
    assert root["labels"] == {"step": "sgd"} and "parent" not in root
    kids = sorted((r for r in recs if r["name"] != "train.step"),
                  key=lambda r: r["start"])
    assert tuple(r["name"] for r in kids) == PHASES
    end = root["start"] + root["dur"]
    for a, b in zip(kids, kids[1:]):
        assert a["start"] + a["dur"] <= b["start"] + 1e-4
    for r in kids:
        assert r["trace"] == root["trace"] and r["parent"] == root["span"]
        assert root["start"] <= r["start"]
        assert r["start"] + r["dur"] <= end + 1e-4
        assert r["ts"] == pytest.approx(r["start"] + r["dur"], abs=1e-3)


def test_dispatch_histogram_is_the_roots_duration(sgd_step):
    (root,) = [r for r in sgd_step["recs"] if r["name"] == "train.step"]
    total, count = sgd_step["hist"]
    assert count == 1
    assert total == pytest.approx(root["dur"], rel=1e-12)


def test_collectives_counted_at_each_site(sgd_step, model):
    ts = sgd_step["ts"]
    chans = [t.shape[0] for k, t in _named(ts.model_state)
             if k.endswith("mean")]
    spec_ = flatten_lib.make_bucket_spec(ts.params, BUCKET_BYTES)
    assert (len(chans), len(spec_.buckets)) == (53, 8)
    assert sgd_step["calls"] == {"bn_fwd": 53, "bn_bwd": 53, "grad": 8,
                                 "loss": 1, "other": 0}
    assert sum(sgd_step["calls"].values()) == 115
    assert sgd_step["bytes"] == {
        "bn_fwd": sum((2 * c + 1) * 4 for c in chans),
        "bn_bwd": sum(2 * c * 4 for c in chans),
        "grad": sum(b.padded * 4 for b in spec_.buckets),
        "loss": 4, "other": 0}


def _named(tree_, pre=""):
    for k, v in tree_.items():
        if isinstance(v, dict):
            yield from _named(v, pre + k + "/")
        else:
            yield pre + k, v


def test_scanned_step_records_the_root_alone(tree, model):
    ts = ttr.init_train_state(model, tree, 0, 1000)
    scan = ttr.build_sgd_scan_step(model, tree, LR, fused=True,
                                   max_bucket_bytes=BUCKET_BYTES)
    x, y = _batch(1)
    recs = _new_records(lambda: scan(ts, x[None], y[None]))
    assert [(r["name"], r["labels"]) for r in recs] == \
        [("train.step", {"step": "sgd_scan"})]


class _FakeCapture:
    """Stands in for a CUDA graph capture on the CPU: the program runs once
    at the capture (where the graph's counts are taken) and not at a
    replay."""

    def __init__(self, program, state, batch, device):
        self.counters = mesh_lib.collective_tally()
        before = [c.value for c in self.counters]
        self.out = program(state, *batch)
        self.counts = [c.value - b for c, b in zip(self.counters, before)]

    def replay(self, state, batch):
        return self.out


def test_graphed_step_counts_its_collectives_each_replay(tree, model,
                                                         monkeypatch):
    """A graphed program counts at each call the collectives its replay
    issues: the capture's counts for the first, the same again for every
    later one."""
    monkeypatch.setattr(graphs, "_Capture", _FakeCapture)
    ts = ttr.init_train_state(model, tree, 0, 1000)
    body = ttr._make_sgd_body(model, tree, LR, True, BUCKET_BYTES,
                              phases=False)

    def program(state, xs, ys):
        return body(state, xs[0], ys[0], None)
    graphed = graphs.GraphedProgram(program, torch.device("cuda"))
    x, y = _batch(5)
    calls0 = _counts("collective_calls_total")
    for _ in range(3):
        graphed(ts, x[None], y[None])
    calls = _counts("collective_calls_total")
    assert {k: v - calls0.get(k, 0) for k, v in calls.items()} == \
        {"bn_fwd": 3 * 53, "bn_bwd": 3 * 53, "grad": 3 * 8, "loss": 3,
         "other": 0}


def test_device_dataset_gather_records_its_span():
    x, y = _batch(2)
    dds = DeviceDataset(x, y, 1000, device="cpu")
    recs = _new_records(lambda: dds.gather(np.array([1, 0])))
    assert [r["name"] for r in recs] == ["data.gather"]
    assert "trace" not in recs[0]


def test_telemetry_off_records_nothing(model):
    obs.configure(False)
    try:
        tree_off = MeshTree(device="cpu")
        ts = ttr.init_train_state(model, tree_off, 0, 1000)
        step = ttr.build_sgd_step(model, tree_off, LR, fused=True,
                                  max_bucket_bytes=BUCKET_BYTES)
        x, y = _batch(3)
        dds = DeviceDataset(x, y, 1000, device="cpu")
        before = (_counts("collective_calls_total"),
                  _counts("collective_bytes_total"), _dispatch())
        recs = _new_records(lambda: step(ts, *dds.gather(np.array([0, 1]))))
        assert recs == []
        assert (_counts("collective_calls_total"),
                _counts("collective_bytes_total"), _dispatch()) == before
    finally:
        obs.configure(None)


def test_span_start_is_on_the_profiler_clock(tree, model, tmp_path):
    """A span's ``start``, through the trace's ``baseTimeNanoseconds``,
    lands within 500 us of the bridge's range of the same span (after a
    first range: the process's first one under a profiler takes about a
    millisecond to open)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    ts = ttr.init_train_state(model, tree, 0, 1000)
    step = ttr.build_sgd_step(model, tree, LR)
    x, y = _batch(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("first"):
            pass
        recs = _new_records(lambda: step(ts, x, y))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base_us = data["baseTimeNanoseconds"] / 1e3
    ann = {e["name"]: e["ts"] for e in data["traceEvents"]
           if e.get("cat") == "user_annotation"}
    assert {r["name"] for r in recs} == {"train.step", *PHASES}
    for r in recs:
        assert spans.on_trace(r, base_us)[1] == \
            pytest.approx(ann[r["name"]], abs=500)
    assert spans.profiler_base_us() == base_us


# ---------------------------------------------------------------------------
# the benchmark's readers on a synthetic run and trace (microseconds on the
# trace's clock; records in epoch seconds from BASE_US)

BASE_US = 1.7e15
#: epoch seconds near 1.7e9 hold a time to 0.24 us
TOL_MS = 5e-4
NEW = ("forward_host_ms", "backward_host_ms", "grad_sum_host_ms",
       "update_host_ms", "gather_host_ms", "idle_dispatch_ms",
       "idle_data_ms")


def _rec(name, start_us, dur_us, **kw):
    s = (BASE_US + start_us) * 1e-6
    return {"type": "span", "name": name, "start": s,
            "ts": s + dur_us * 1e-6, "dur": dur_us * 1e-6, **kw}


def _step(k, t0, phases=(10, 20, 5, 5), gather=4.0):
    """Step ``k`` at ``t0``: a gather, then the root over its phases."""
    out = [_rec("data.gather", t0, gather)]
    t = t0 + gather + 1
    kids = []
    for name, d in zip(PHASES, phases):
        kids.append(_rec(name, t, d, trace=f"t{k}", span=f"c{k}{name}",
                         parent=f"r{k}"))
        t += d
    root = _rec("train.step", t0 + gather + 1, t - (t0 + gather + 1) + 2,
                labels={"step": "sgd"}, trace=f"t{k}", span=f"r{k}")
    return out + kids + [root]


def _run(n_window, trace_=None):
    run = harness.Run(cfg={}, mix={}, params=0, flops_per_sample=0.0)
    run.steps = n_window
    run.trace = trace_
    return run


def _read(run):
    return {m: spec.metric_module(m).read(run) for m in NEW}


def test_readers_take_the_window_and_the_profiled_steps():
    # one set-up step, two window steps at 100 and 200, one profiled at 300
    recs = [r for k, t in enumerate((0, 100, 200, 300))
            for r in _step(k, t, phases=(10 * (k + 1), 20, 5, 5))]
    kernels = [("k", 300.0, 8.0), ("sgd_chunk", 320.0, 30.0),
               ("k", 360.0, 10.0)]
    host = [("cudaLaunchKernel", 306.0, 1.0),
            ("cudaLaunchKernel", 318.0, 1.0)]
    tr = trace.Trace(kernels, host, 300.0, 370.0, 1)
    run = _run(2, tr)
    spans.attach(run, recs, base_us=BASE_US)
    got = _read(run)
    # the window's forwards are 20 and 30 us, a mean of 0.025 ms
    assert got["forward_host_ms"] == pytest.approx(0.025)
    assert got["backward_host_ms"] == pytest.approx(0.020)
    assert got["grad_sum_host_ms"] == pytest.approx(0.005)
    assert got["update_host_ms"] == pytest.approx(0.005)
    assert got["gather_host_ms"] == pytest.approx(0.004)
    # idle 308-320 and 350-360; the root spans 305-377, the gather 300-304
    assert got["idle_dispatch_ms"] == pytest.approx(0.022, abs=TOL_MS)
    assert got["idle_data_ms"] == 0.0
    # the gaps begin inside the forward and the backward
    gaps = dict(trace.breakdown(tr)["idle_gaps"])
    assert gaps == pytest.approx({"train.forward": 12e-6,
                                  "train.backward": 10e-6}, abs=1e-9)


def test_readers_count_overlapping_spans_and_cut_at_the_window():
    # a window step, then two profiled steps whose roots overlap (5-47 and
    # 35-77); the window opens at 10, inside the first root, after its
    # gather (0-4); the second gather is 30-34
    recs = _step(0, -200) + _step(1, 0) + _step(2, 30)
    tr = trace.Trace([("k", 10.0, 5.0), ("k", 100.0, 10.0)], [], 10.0,
                     110.0, 2)
    run = _run(1, tr)
    spans.attach(run, recs, base_us=BASE_US)
    steps = spans.of(run)
    assert (len(steps.window), len(steps.profiled)) == (1, 2)
    assert len(steps.gathers_window) == 1 and \
        len(steps.gathers_profiled) == 2
    # idle 15-100: the roots' union (5-77) covers 15-77, the gathers 30-34
    assert [(a, b) for a, b in trace.idle_gaps(tr)] == [(15.0, 100.0)]
    assert spans.idle_ms(run, spans.ROOT) == pytest.approx(62 / 2 * 1e-3,
                                                          abs=TOL_MS)
    assert spans.idle_ms(run, spans.GATHER) == pytest.approx(4 / 2 * 1e-3,
                                                            abs=TOL_MS)


def test_readers_find_nothing_without_the_programs_spans():
    tr = trace.Trace([("k", 0.0, 1.0)], [], 0.0, 2.0, 1)
    for t in (None, tr):
        run = _run(3, t)
        spans.attach(run, [_rec("other", 0, 1)], base_us=BASE_US)
        assert set(_read(run).values()) == {None}


def test_a_ring_that_lost_the_window_fails():
    recs = _step(0, 0) + _step(1, 100)
    with pytest.raises(RuntimeError, match="lost records"):
        spans.split(recs, 3, 0)
    with pytest.raises(RuntimeError, match="lost records"):
        spans.split(recs[1:], 2, 0, dropped=1)
    assert len(spans.split(recs[1:], 1, 0, dropped=1).window) == 1


def test_collective_calls_reader(monkeypatch):
    mod = spec.metric_module("collective_calls")
    monkeypatch.setattr(spans, "counter", lambda name: {
        "bn_fwd": 530, "bn_bwd": 530, "grad": 80, "loss": 10, "other": 0})
    monkeypatch.setattr(harness, "_dispatch_totals", lambda: (1.0, 10))
    assert mod.read(_run(1)) == 115.0
    monkeypatch.setattr(spans, "counter", lambda name: {})
    assert mod.read(_run(1)) is None


def test_collective_mib_reader(monkeypatch):
    mod = spec.metric_module("collective_mib")
    monkeypatch.setattr(spans, "counter", lambda name: {
        "bn_fwd": 3 * 2**20, "grad": 17 * 2**20, "loss": 40})
    monkeypatch.setattr(harness, "_dispatch_totals", lambda: (1.0, 10))
    assert mod.read(_run(1)) == pytest.approx(2.0 + 4 / 2**20)
    monkeypatch.setattr(spans, "counter", lambda name: {})
    assert mod.read(_run(1)) is None


def test_every_new_reader_has_its_entry():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW + ("collective_calls", "collective_mib"):
        m, mod = entries[name], spec.metric_module(name)
        assert (m["unit"], m["source"], m["layer"], m["moves"]) == \
            (mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert m["workloads"] == ["resnet50.sgd.bf16.b256"]
