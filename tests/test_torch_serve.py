"""The port's decode service against the JAX package's, on the CPU at the
JAX serve tests' size: the same JAX params (carried across by
``lm_from_jax``), the same prompts and the same admission schedule must
give the same tokens through continuous batching, chunked prefill, a
cached prefix and speculative verify; the host-side caches and the drafter
behave the same in both packages; the 'G'/'R' frames are byte-identical,
and a JAX client drives a port server and the reverse.

Tokens are compared exactly: both packages compute in float32 on the CPU,
and the argmax of these small random models has no near-ties at the
prompts used here (float32 rounding differences are ~1e-6)."""

from __future__ import annotations

import socket
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.comm import transport as jax_transport  # noqa: E402
from distlearn_tpu.models.transformer import greedy_generate as jax_greedy  # noqa: E402
from distlearn_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from distlearn_tpu.serve import kv_cache as jax_kv  # noqa: E402
from distlearn_tpu.serve import prefix_cache as jax_prefix  # noqa: E402
from distlearn_tpu.serve import speculate as jax_spec  # noqa: E402
from distlearn_tpu.serve.client import ServeClient as JaxClient  # noqa: E402
from distlearn_tpu.serve.engine import DecodeEngine as JaxEngine  # noqa: E402
from distlearn_tpu.serve.scheduler import Scheduler as JaxScheduler  # noqa: E402
from distlearn_tpu.serve.server import ServeServer as JaxServer  # noqa: E402
from distlearn_tpu_torch.comm import transport as port_transport  # noqa: E402
from distlearn_tpu_torch.models.convert import lm_from_jax  # noqa: E402
from distlearn_tpu_torch.models.transformer import greedy_generate  # noqa: E402
from distlearn_tpu_torch.serve import kv_cache as port_kv  # noqa: E402
from distlearn_tpu_torch.serve import prefix_cache as port_prefix  # noqa: E402
from distlearn_tpu_torch.serve import speculate as port_spec  # noqa: E402
from distlearn_tpu_torch.serve.client import ServeClient as PortClient  # noqa: E402
from distlearn_tpu_torch.serve.engine import DecodeEngine as PortEngine  # noqa: E402
from distlearn_tpu_torch.serve.engine import _sample_token  # noqa: E402
from distlearn_tpu_torch.serve.scheduler import Scheduler as PortScheduler  # noqa: E402
from distlearn_tpu_torch.serve.server import ServeServer as PortServer  # noqa: E402

VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    params, _ = jax_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                       max_len=MAX_LEN).init(jax.random.PRNGKey(0))
    return jax.device_get(params)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return lm_from_jax(jax_params)


def _engines(jax_params, port_params, **kw):
    return (JaxEngine(jax_params, max_len=MAX_LEN, page=8, **kw),
            PortEngine(port_params, max_len=MAX_LEN, page=8, device="cpu",
                       **kw))


def _prompts(n, lo=3, hi=9, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _greedy_ref(params, prompt, steps):
    out = jax_greedy(params, np.asarray(prompt, np.int32)[None], steps)
    return np.asarray(out)[0].tolist()


def _continuous(eng, prompts, max_new):
    """Admit one request per loop turn while capacity lasts, tick, finish
    at max_new: the JAX serve test's staggered schedule."""
    pending = list(range(len(prompts)))
    live, got = {}, {}
    while pending or live:
        if pending and eng.has_capacity(len(prompts[pending[0]]), max_new):
            i = pending.pop(0)
            slot, first = eng.admit(prompts[i], max_new)
            live[slot] = {"i": i, "toks": [first]}
        for slot, tok in eng.tick().items():
            live[slot]["toks"].append(tok)
        for slot in [s for s, st in live.items()
                     if len(st["toks"]) >= max_new]:
            st = live.pop(slot)
            eng.finish(slot)
            got[st["i"]] = st["toks"]
    eng.cache.check()
    return [got[i] for i in range(len(prompts))]


def test_engine_continuous_batching_matches_jax(jax_params, port_params):
    prompts = _prompts(6)
    je, pe = _engines(jax_params, port_params, num_slots=3)
    port = _continuous(pe, prompts, 7)
    assert port == _continuous(je, prompts, 7)
    assert port == [_greedy_ref(jax_params, p, 7) for p in prompts]
    assert pe.cache.free_pages() == pe.cache.num_pages - 1


def _chunked(eng, prompt, max_new, chunk):
    job = eng.begin(prompt, max_new)
    first, rounds = None, 0
    while first is None:
        first = eng.prefill_step(job, chunk=chunk)
        rounds += 1
    toks = [first]
    while len(toks) < max_new:
        toks.append(eng.tick()[job.slot])
    eng.finish(job.slot)
    return toks, rounds


@pytest.mark.parametrize("chunk", [5, 7, 64])
def test_chunked_prefill_matches_jax(jax_params, port_params, chunk):
    prompt = np.random.default_rng(9).integers(1, VOCAB, 20).astype(np.int32)
    je, pe = _engines(jax_params, port_params, num_slots=2)
    got = _chunked(pe, prompt, 6, chunk)
    assert got == _chunked(je, prompt, 6, chunk)
    assert got[0] == _greedy_ref(jax_params, prompt, 6)


def _cached_prefix(eng, prefix_mod, base, variant):
    cache = prefix_mod.RadixPrefixCache(eng.cache)
    slot, first = eng.admit(base, 4)
    cache.insert(base, eng.cache.block_table[slot])
    toks = [first] + [eng.tick()[slot] for _ in range(3)]
    eng.finish(slot)
    cached, pages = cache.match(variant)
    job = eng.begin(variant, 6, shared=pages)
    first = None
    while first is None:
        first = eng.prefill_step(job)
    out = [first]
    while len(out) < 6:
        out.append(eng.tick()[job.slot])
    eng.finish(job.slot)
    cache.check()
    cache.clear()
    return toks, cached, out


def test_cached_prefix_matches_jax(jax_params, port_params):
    base = np.random.default_rng(11).integers(1, VOCAB, 20).astype(np.int32)
    variant = base.copy()
    variant[18:] = (variant[18:] % (VOCAB - 1)) + 1
    je, pe = _engines(jax_params, port_params, num_slots=2)
    got = _cached_prefix(pe, port_prefix, base, variant)
    assert got == _cached_prefix(je, jax_prefix, base, variant)
    assert got[1] == 16
    assert got[2] == _greedy_ref(jax_params, variant, 6)
    assert pe.cache.free_pages() == pe.cache.num_pages - 1


def _verify_rounds(eng, prompt, ref):
    slot, first = eng.admit(prompt, 10)
    outs = [first]
    for drafts in ([(ref[1] + 1) % VOCAB, (ref[2] + 3) % VOCAB], ref[2:5],
                   [ref[6], (ref[7] + 1) % VOCAB]):
        outs.append(eng.verify({slot: drafts})[slot])
    while sum(len(o) if isinstance(o, list) else 1 for o in outs) < 10:
        outs.append(eng.tick()[slot])
    eng.finish(slot)
    eng.cache.check()
    return outs


def test_verify_matches_jax(jax_params, port_params):
    prompt = np.random.default_rng(5).integers(1, VOCAB, 7).astype(np.int32)
    ref = _greedy_ref(jax_params, prompt, 10)
    je, pe = _engines(jax_params, port_params, num_slots=2)
    got = _verify_rounds(pe, prompt, ref)
    assert got == _verify_rounds(je, prompt, ref)
    assert got[1:4] == [ref[1:2], ref[2:6], ref[6:8]]


def _run_scheduler(sched, prompts, max_new, eos=None):
    rids = [sched.submit(p, max_new, eos=eos) for p in prompts]
    toks = {r: [] for r in rids}
    reasons = {}
    for _ in range(500):
        for ev in sched.step():
            if ev.kind == "token":
                toks[ev.rid].append(ev.token)
            else:
                reasons[ev.rid] = ev.reason
        if len(reasons) == len(rids):
            break
    return [toks[r] for r in rids], [reasons[r] for r in rids]


@pytest.mark.parametrize("speculate", [False, True])
def test_scheduler_matches_jax(jax_params, port_params, speculate):
    prompts = _prompts(5, seed=4) + [np.tile(np.array([3, 5, 7], np.int32),
                                             6)]
    je, pe = _engines(jax_params, port_params, num_slots=2)
    kw = lambda mod: {"drafter": mod.NGramDrafter()} if speculate else {}
    port = _run_scheduler(PortScheduler(pe, prefill_chunk=4,
                                        **kw(port_spec)), prompts, 9)
    assert port == _run_scheduler(JaxScheduler(je, prefill_chunk=4,
                                               **kw(jax_spec)), prompts, 9)
    assert port[0] == [_greedy_ref(jax_params, p, 9) for p in prompts]
    pe.cache.check()


def test_greedy_generate_matches_engine_on_port_params(port_params,
                                                       jax_params):
    """The port's own reference decoder agrees with its engine (the check
    chip_smoke.py makes on the card)."""
    prompt = _prompts(1, seed=8)[0]
    pe = PortEngine(port_params, num_slots=1, device="cpu")
    slot, first = pe.admit(prompt, 8)
    toks = [first] + [pe.tick()[slot] for _ in range(7)]
    ref = greedy_generate(port_params, prompt[None], 8)[0].tolist()
    assert toks == ref == _greedy_ref(jax_params, prompt, 8)


def test_engine_swap_params_parity_and_validation(jax_params, port_params):
    new = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, jax_params)
    pe = PortEngine(port_params, num_slots=1, max_len=MAX_LEN, page=8,
                    device="cpu")
    prompt = _prompts(1, seed=2)[0]
    pe.swap_params(new)                         # numpy JAX tree accepted
    slot, first = pe.admit(prompt, 5)
    toks = [first] + [pe.tick()[slot] for _ in range(4)]
    pe.finish(slot)
    assert toks == _greedy_ref(new, prompt, 5)
    bad = dict(new, embed=np.zeros((VOCAB + 1, DIM), np.float32))
    with pytest.raises(ValueError, match="leaf mismatch"):
        pe.swap_params(bad)
    with pytest.raises(ValueError, match="depth"):
        pe.swap_params({k: v for k, v in new.items() if k != "block1"})


def test_engine_validation(port_params):
    pe = PortEngine(port_params, num_slots=1, max_len=MAX_LEN, page=8,
                    device="cpu")
    with pytest.raises(ValueError):
        pe.admit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError):
        pe.admit(np.ones(MAX_LEN, np.int32), 1)
    with pytest.raises(NotImplementedError, match="A12"):
        PortEngine(port_params, mesh=object(), tp_axis="model",
                   device="cpu")


# -- sampling -----------------------------------------------------------------

def test_sampling_deterministic_and_temp0_bitwise(port_params, jax_params):
    prompt = np.random.default_rng(3).integers(1, VOCAB, 7).astype(np.int32)
    ref = _greedy_ref(jax_params, prompt, 8)
    pe = PortEngine(port_params, num_slots=2, max_len=MAX_LEN, page=8,
                    device="cpu")

    def run(**kw):
        slot, first = pe.admit(prompt, 8, **kw)
        toks = [first] + [pe.tick()[slot] for _ in range(7)]
        pe.finish(slot)
        return toks

    a = run(temperature=0.9, top_k=12, top_p=0.95, seed=123)
    assert a == run(temperature=0.9, top_k=12, top_p=0.95, seed=123)
    assert any(run(temperature=3.0, seed=s) != ref for s in (7, 8, 9))
    assert run(temperature=2.0, top_k=1, seed=5) == ref   # only the argmax
    # a sampled stream does not depend on what shares its batch
    s_hot, f_hot = pe.admit(prompt, 8, temperature=0.9, top_k=12,
                            top_p=0.95, seed=123)
    s_cold, f_cold = pe.admit(prompt, 8)
    hot, cold = [f_hot], [f_cold]
    while len(cold) < 8:
        out = pe.tick()
        hot.append(out[s_hot])
        cold.append(out[s_cold])
    pe.finish(s_hot)
    pe.finish(s_cold)
    assert cold == ref and hot == a
    pe.cache.check()


def test_sample_token_filters_like_jax():
    """top-k and top-p keep exactly the tokens the JAX rule keeps: a token
    drawn with a filter never lies outside it, over many (seed, position)
    keys, and temperature 0 is the first index of the maximum."""
    lg = torch.tensor([1.0, 3.0, 3.0, 2.5, -1.0, 0.5])
    assert _sample_token(lg, 0.0, 0, 0.0, 0, 0) == 1
    probs = torch.softmax(torch.sort(lg, descending=True).values, -1)
    before = torch.cumsum(probs, -1) - probs
    nucleus = {1, 2, 3}     # mass strictly before the 4th sorted token >= 0.9
    assert float(before[3]) >= 0.9 > float(before[2])
    seen_k, seen_p = set(), set()
    for key in range(200):
        seen_k.add(_sample_token(lg, 1.0, 2, 0.0, key, 3))
        seen_p.add(_sample_token(lg, 1.0, 0, 0.9, 7, key))
    assert seen_k == {1, 2}
    assert seen_p == nucleus


# -- host-side caches and the drafter: one scenario, both packages ----------

def _kv_accounting(kv, _prefix, _spec):
    c = kv.PagedKVCache(num_slots=2, page=4, max_len=16)
    s0, s1 = c.admit(10), c.admit(16)
    c.check()
    with pytest.raises(kv.CacheFull):
        c.admit(4)
    c.release(s0)
    with pytest.raises(ValueError):
        c.release(s0)
    out = (c.num_pages, sorted(c._free), c.block_table.tolist(),
           c.can_admit(8 * 4), c.can_admit(17))
    c.release(s1)
    c.check()
    return out + (c.free_pages(),)


def _kv_sharing(kv, _prefix, _spec):
    c = kv.PagedKVCache(num_slots=3, page=4, max_len=16)
    a = c.admit(12)
    shared = [int(p) for p in c.block_table[a, :2]]
    b = c.admit(12, shared=shared)
    c.release(a)
    freed = c.unref([])
    c.check()
    return (c.ref.tolist(), c.block_table.tolist(), freed, b,
            c.free_pages())


def _radix(kv, prefix, _spec):
    k = kv.PagedKVCache(num_slots=3, page=4, max_len=32)
    cache = prefix.RadixPrefixCache(k)
    out = []
    for seed in range(4):
        p = np.random.default_rng(seed % 2).integers(1, 50, 13 + seed)
        cached, pages = cache.match(p)
        slot = k.admit(len(p) + 2, shared=pages)
        cache.insert(p, k.block_table[slot])
        out.append((cached, list(pages), slot))
        k.release(slot)
    cache.check()
    out.append(cache.evict_for_free(k.num_pages))
    out.append(cache.clear())
    k.check()
    return out


def _drafter(_kv, _prefix, spec):
    d = spec.NGramDrafter(k=4, n_max=3)
    return [d.propose(c, k=kk) for c, kk in (
        ([5, 6, 7, 8, 9, 1, 5, 6, 7], None), ([2, 9, 3, 2, 9, 4, 2, 9], None),
        ([5, 6, 7, 8, 9, 1, 5, 6, 7], 1), ([1, 2, 3, 4, 5], None),
        ([4, 4, 4, 4], 2))]


_SCENARIOS = {"kv_accounting": _kv_accounting, "kv_sharing": _kv_sharing,
              "radix": _radix, "drafter": _drafter}
_PACKAGES = {"jax": (jax_kv, jax_prefix, jax_spec),
             "port": (port_kv, port_prefix, port_spec)}


@pytest.mark.parametrize("package", sorted(_PACKAGES))
@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_host_side_scenarios_agree(scenario, package):
    """Each scenario runs in both packages; the port's result must equal
    the JAX package's."""
    got = _SCENARIOS[scenario](*_PACKAGES[package])
    assert got == _SCENARIOS[scenario](*_PACKAGES["jax"])


# -- wire frames and cross-package service ------------------------------------

def _tcp_pair():
    """A connected loopback TCP pair (the transport sets TCP_NODELAY)."""
    with socket.create_server(("127.0.0.1", 0)) as lst:
        a = socket.create_connection(lst.getsockname())
        b, _ = lst.accept()
    return a, b


def _frame_bytes(transport_mod, send, msg) -> bytes:
    a, b = _tcp_pair()
    try:
        conn = transport_mod.Conn(a)
        getattr(conn, send)(msg)
        b.settimeout(5)
        data = b""
        while len(data) < 9 or len(data) < 9 + int.from_bytes(
                data[1:9], "little"):
            data += b.recv(1 << 16)
        return data
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("send,msg", [
    ("send_gen", {"rid": "r1", "prompt": [1, 2, 3], "max_new": 4}),
    ("send_gen", {"rid": "r2", "prompt": [5], "max_new": 1,
                  "temperature": 0.7, "top_k": 3, "top_p": 0.9, "seed": 11}),
    ("send_stream", {"rid": "r1", "tokens": [7, 8], "done": False,
                     "epoch": None}),
    ("send_stream", {"rid": "r1", "tokens": [], "done": True,
                     "reason": "complete", "epoch": 3, "accepted": 2}),
])
def test_serve_frames_byte_identical(send, msg):
    data = _frame_bytes(port_transport, send, msg)
    assert data == _frame_bytes(jax_transport, send, msg)
    a, b = _tcp_pair()
    try:
        port_transport.Conn(a).send_gen(msg) if send == "send_gen" \
            else port_transport.Conn(a).send_stream(msg)
        kind, got = jax_transport.Conn(b).recv_serve()
    finally:
        a.close()
        b.close()
    assert (kind, got) == ("G" if send == "send_gen" else "R", msg)


def _serve_roundtrip(server, client_cls, prompts, max_new):
    server.start()
    out = {}
    try:
        def run(i):
            with client_cls(server.host, server.port) as c:
                out[i] = c.generate(prompts[i], max_new, rid=f"q{i}")
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        server.stop()
    return [out[i]["tokens"] for i in range(len(prompts))], \
        [out[i]["reason"] for i in range(len(prompts))]


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_cross_package_serving(jax_params, port_params, server_pkg,
                               client_pkg):
    prompts = _prompts(3, seed=6)
    if server_pkg == "port":
        srv = PortServer(PortEngine(port_params, num_slots=2, max_len=MAX_LEN,
                                    page=8, device="cpu"), idle_wait=0.01)
    else:
        srv = JaxServer(JaxEngine(jax_params, num_slots=2, max_len=MAX_LEN,
                                  page=8), idle_wait=0.01)
    client = PortClient if client_pkg == "port" else JaxClient
    toks, reasons = _serve_roundtrip(srv, client, prompts, 6)
    assert reasons == ["complete"] * 3
    assert toks == [_greedy_ref(jax_params, p, 6) for p in prompts]


def test_port_server_rejects_and_reports_health(port_params):
    srv = PortServer(PortEngine(port_params, num_slots=1, max_len=MAX_LEN,
                                page=8, device="cpu"), idle_wait=0.01)
    srv.start()
    try:
        with JaxClient(srv.host, srv.port) as c:
            health = c.ping()
            with pytest.raises(Exception, match="max_len"):
                c.generate(list(range(1, MAX_LEN + 1)), 4, rid="too-long")
    finally:
        srv.stop()
    assert health["ok"] and health["serving"] and health["active"] == 0


def test_sigterm_drains_in_flight_request(jax_params, port_params):
    """The example's SIGTERM hook (a copy of ``ha.install_signal_flush``)
    finishes the in-flight request before the prior handler runs."""
    import signal

    from distlearn_tpu_torch.examples.lm import install_signal_flush
    prompt = _prompts(1, seed=9)[0]
    srv = PortServer(PortEngine(port_params, num_slots=1, max_len=MAX_LEN,
                                page=8, device="cpu"), idle_wait=0.01)
    srv.start()
    out, chained = {}, []
    old = signal.signal(signal.SIGTERM, lambda *a: chained.append(a[0]))
    try:
        install_signal_flush(srv)

        def run():
            with PortClient(srv.host, srv.port) as c:
                out["r"] = c.generate(prompt, 20)

        t = threading.Thread(target=run)
        t.start()
        while not srv.sched.active_count() and t.is_alive():
            threading.Event().wait(0.005)
        signal.raise_signal(signal.SIGTERM)
        t.join(30)
    finally:
        signal.signal(signal.SIGTERM, old)
        srv.stop()
    assert chained == [signal.SIGTERM]
    assert out["r"]["reason"] == "complete"
    assert out["r"]["tokens"] == _greedy_ref(jax_params, prompt, 20)


def test_examples_generate_and_client_on_the_cpu(port_params, capsys):
    """The port's ``examples/lm.py`` decodes from its seeded init, and its
    ``lm_client`` drives a port server."""
    from distlearn_tpu_torch.examples import lm, lm_client
    assert lm.main(["--steps", "0", "--generate", "3", "--device", "cpu",
                    "--vocab", "61", "--dim", "32", "--depth", "1",
                    "--seqLen", "64"]) == 0
    assert capsys.readouterr().out.count("generated 3 tokens") == 2
    srv = PortServer(PortEngine(port_params, num_slots=2, max_len=MAX_LEN,
                                page=8, device="cpu"), idle_wait=0.01)
    srv.start()
    try:
        lm_client.main(["--port", str(srv.port), "--maxNew", "4",
                        "--concurrency", "2"])
    finally:
        srv.stop()
    out = capsys.readouterr().out
    assert out.count("4 tokens (ttft") == 2 and "8 tokens over 2" in out
