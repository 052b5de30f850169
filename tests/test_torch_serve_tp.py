"""The port's tensor-parallel decode engine against the JAX package's, on
the CPU at the JAX serve tests' size: two gloo ranks in child processes
(``tests/torch_serve_worker.py``), rank 0 the engine's leader and rank 1 a
follower replaying its ops, hold the same weights (the JAX params whole;
each rank takes its 2-head shard) and must emit the tokens of JAX's tp
engine (``tests/test_serve.py::test_engine_parity_tp_sharded``, the same
prompts and schedule) and of JAX's ``greedy_generate`` — through full and
chunked prefill, ticks, speculative verify, a cached shared prefix behind
the server, ``swap_params`` on the whole tree and an epoch-fenced hot swap
from a checkpoint.  The follower leaves ``follow()`` on the server's stop,
and with an error when the leader dies; ``examples/lm.py --serve --tp 2``
serves the same way.

Tokens are compared exactly: float32 on the CPU, and these small random
models have no near-ties at the prompts used (tests/test_torch_serve.py).
"""

from __future__ import annotations

import ast
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.models.transformer import greedy_generate as jax_greedy  # noqa: E402
from distlearn_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from distlearn_tpu.serve.engine import DecodeEngine as JaxEngine  # noqa: E402
from distlearn_tpu_torch.serve.engine import DecodeEngine as PortEngine  # noqa: E402

import torch_mesh_worker  # noqa: E402
import torch_serve_worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64
MAX_NEW, VERIFY_NEW = 5, 12


def _prompts(n, lo=3, hi=9, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _jax_params():
    params, _ = jax_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                       max_len=MAX_LEN).init(jax.random.PRNGKey(0))
    return jax.device_get(params)


def _scaled(params):
    return jax.tree_util.tree_map(lambda a: (a * 0.5).astype(a.dtype),
                                  params)


def _greedy(params, prompt, steps):
    out = jax_greedy(params, np.asarray(prompt, np.int32)[None], steps)
    return np.asarray(out)[0].tolist()


def _case(tmp):
    params = _jax_params()
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, VOCAB, 16).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(1, VOCAB, n)
                              .astype(np.int32)]) for n in (5, 9)]
    return {"params": params, "params2": _scaled(params),
            "prompts": _prompts(2, seed=3), "long":
            rng.integers(1, VOCAB, 20).astype(np.int32),
            "shared": shared, "max_new": MAX_NEW, "verify_new": VERIFY_NEW,
            "max_len": MAX_LEN, "vocab": VOCAB, "prefill_chunk": 8,
            "ckpt_dir": str(tmp / "ckpt")}


def _jax_side(case):
    """JAX's tp engine on a 2-device mesh over the same prompts and
    schedule, and JAX's greedy_generate for every stream."""
    from jax.sharding import Mesh
    params = case["params"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    eng = JaxEngine(params, num_slots=2, max_len=MAX_LEN, page=8, mesh=mesh,
                    tp_axis="model")
    slots = {}
    for i, p in enumerate(case["prompts"]):
        slot, first = eng.admit(p, MAX_NEW)
        slots[slot] = {"i": i, "toks": [first]}
    for _ in range(MAX_NEW - 1):
        for slot, tok in eng.tick().items():
            slots[slot]["toks"].append(tok)
    tp = [None] * len(case["prompts"])
    for slot, st in slots.items():
        eng.finish(slot)
        tp[st["i"]] = st["toks"]
    p2 = case["params2"]
    return {"tp": tp,
            "greedy": [_greedy(params, p, MAX_NEW) for p in case["prompts"]],
            "long": _greedy(params, case["long"], MAX_NEW),
            "verify": _greedy(params, case["long"], VERIFY_NEW),
            "shared": [_greedy(params, p, MAX_NEW) for p in case["shared"]],
            "swapped": _greedy(p2, case["prompts"][0], MAX_NEW)}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    def compute():
        tmp = tmp_path_factory.mktemp("serve_tp")
        case = _case(tmp)
        ranks, ref = torch_serve_worker.spawn(
            2, case, str(tmp), meanwhile=lambda: _jax_side(case))
        return ranks, ref
    return torch_mesh_worker.once_per_session("serve_tp", tmp_path_factory,
                                              compute)


def test_tp_engine_matches_jax_tp_engine_and_greedy(tp_run):
    (leader, follower), ref = tp_run
    assert leader["parity"] == ref["tp"] == ref["greedy"]
    # each rank keeps half the heads of the pools and weights
    assert leader["heads"] == follower["heads"] == HEADS // 2
    assert leader["pool"] == follower["pool"]
    assert leader["pool"][3] == HEADS // 2


def test_tp_tick_runs_two_psums_a_block(tp_run):
    (leader, _), _ = tp_run
    assert leader["tick_psums"] == 2 * DEPTH


def test_tp_chunked_prefill(tp_run):
    (leader, _), ref = tp_run
    assert leader["chunked"] == ref["long"]


def test_tp_verify_emits_the_greedy_stream(tp_run):
    (leader, _), ref = tp_run
    assert leader["verify"] == ref["verify"]
    # the drafts were mostly right: fewer verify rounds than tokens
    assert leader["verify_rounds"] < VERIFY_NEW - 1


def test_tp_swap_params_whole_tree(tp_run):
    (leader, _), ref = tp_run
    assert leader["swapped"] == ref["swapped"]
    assert leader["swapped_back"] == ref["greedy"][0]


def test_tp_server_shared_prefix_and_checkpoint_swap(tp_run):
    (leader, _), ref = tp_run
    served = leader["served"]
    assert [r["tokens"] for r in served] == ref["shared"]
    assert all(r["reason"] == "complete" for r in served)
    # the second request's two whole pages of shared prefix were cached
    assert served[1].get("cached_tokens") == 16
    after = leader["served_after_swap"]
    assert after["tokens"] == ref["swapped"] and after["epoch"] == 2
    assert leader["health"]["epoch"] == 2


def test_follower_exits_cleanly_on_stop(tp_run):
    (leader, follower), _ = tp_run
    assert not follower["leader"] and follower["stopped"]
    assert follower["ops"] > 0


def test_follower_leaves_follow_when_the_leader_dies(tmp_path):
    case = {"params": _jax_params(), "prompts": _prompts(1, seed=3),
            "max_len": MAX_LEN}
    got = torch_serve_worker.spawn_lost_leader(case, str(tmp_path))
    assert got["how"] == "LeaderLost"


def test_tp_engine_validation():
    """JAX's checks (distlearn_tpu/serve/engine.py:140-146): mesh and
    tp_axis come together, and the heads must divide the axis."""
    from types import SimpleNamespace
    from distlearn_tpu_torch.models.convert import lm_from_jax
    params = lm_from_jax(_jax_params())
    mesh = SimpleNamespace(device=torch.device("cpu"), backend="gloo",
                           axis=lambda name: SimpleNamespace(
                               size=3, index=0, ranks=(0, 1, 2)))
    with pytest.raises(ValueError, match="not divisible"):
        PortEngine(params, mesh=mesh, tp_axis="model", device="cpu")
    with pytest.raises(ValueError, match="come together"):
        PortEngine(params, mesh=mesh, device="cpu")


def test_serve_worker_imports_no_jax():
    tree = ast.parse((ROOT / "tests" / "torch_serve_worker.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names] + [n.module for n in ast.walk(tree)
                                 if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "distlearn_tpu")]


def test_lm_example_serves_tp2_on_the_cpu(tmp_path):
    """``examples/lm.py --serve 2 --tp 2 --device cpu``: rank 0 serves as
    the leader, rank 1 follows; a request gets the seeded model's greedy
    tokens, and Ctrl-C (SIGINT to rank 0's process) drains the server,
    stops the follower and exits 0."""
    from distlearn_tpu_torch.examples import lm as lm_example
    from distlearn_tpu_torch.serve import ServeClient
    argv = ["--steps", "0", "--serve", "2", "--tp", "2", "--device", "cpu",
            "--vocab", "64", "--dim", "64", "--depth", "2", "--seqLen", "64"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distlearn_tpu_torch.examples.lm", *argv],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    # a hung server must not hang the run: the read below ends at EOF
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        port = None
        for line in proc.stdout:
            lines.append(line)
            if "serving on" in line:
                port = int(line.split("serving on ")[1].split()[0]
                           .split(":")[1])
                break
        assert port is not None, "".join(lines)
        opt = lm_example.parse(argv)
        params, cd = lm_example.build_model(opt)
        prompt = np.arange(1, 9, dtype=np.int32)
        from distlearn_tpu_torch.models.transformer import greedy_generate
        want = greedy_generate(params, prompt[None], 6)[0].tolist()
        with ServeClient("127.0.0.1", port) as c:
            got = c.generate(prompt, 6, timeout=60)
        assert got["tokens"] == want
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "follower stopped" in text and "serve drained" in text, text
