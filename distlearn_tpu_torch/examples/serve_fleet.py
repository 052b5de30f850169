"""Fault-tolerant serving fleet demo — the JAX package's
``examples/serve_fleet.py`` over the port's engine, server and
:class:`~distlearn_tpu_torch.serve.Router`, with ``--device`` (the card by
default).

One process, whole story: spin ``--replicas`` ServeServer replicas over a
shared tiny LM, put a Router in front, and drive traffic through three
acts:

1. **Steady state** — least-loaded dispatch spreads requests across the
   fleet; every stream completes.
2. **Replica kill** — one replica dies mid-traffic.  Requests it held but
   had not prefilled are resubmitted to survivors by the router; the
   fleet keeps serving.
3. **Hot weight swap** — a new checkpoint lands in the tailed directory
   with a bumped ``epoch``; every replica swaps between decode ticks and
   the router's epoch fence guarantees no stream mixes weights.

    python -m distlearn_tpu_torch.examples.serve_fleet --replicas 3 \\
        --requests 12 [--device cpu]
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time

from distlearn_tpu_torch.utils.flags import parse_flags

VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64


def build_fleet(n, params, ckpt_dir, device, epoch=1):
    from distlearn_tpu_torch.serve import DecodeEngine, ServeServer
    servers = []
    for _ in range(n):
        eng = DecodeEngine(params, num_slots=2, max_len=MAX_LEN, page=8,
                           device=device)
        srv = ServeServer(eng, idle_wait=0.005, ckpt_dir=ckpt_dir,
                          ckpt_poll=0.05, epoch=epoch)
        srv.start()
        servers.append(srv)
    return servers


def fire(router, prompts, max_new, kill_at=None, kill=None):
    """Drive one request per prompt through the router concurrently.
    ``kill`` (a thunk) runs once the ``kill_at``-th request is submitted
    — the mid-traffic fault."""
    results = [None] * len(prompts)

    def one(i):
        if kill_at is not None and i == kill_at:
            kill()
        try:
            results[i] = router.generate(prompts[i], max_new,
                                         rid=f"req{i}", timeout=120)
        except Exception as e:  # noqa: BLE001 — demo: report, don't die
            results[i] = {"reason": f"error: {e}", "tokens": [],
                          "epoch": None, "replica": None}

    threads = []
    for i in range(len(prompts)):
        t = threading.Thread(target=one, args=(i,))
        t.start()
        threads.append(t)
        time.sleep(0.02)         # stagger so the fleet sees a stream
    for t in threads:
        t.join()
    return results


def report(act, results):
    done = sum(1 for r in results if r["reason"] == "complete")
    by_rep: dict = {}
    for r in results:
        if r["replica"]:
            by_rep[r["replica"]] = by_rep.get(r["replica"], 0) + 1
    epochs = sorted({r["epoch"] for r in results if r["epoch"]})
    print(f"[{act}] {done}/{len(results)} complete; "
          f"dispatch={by_rep}; epochs={epochs}")
    return done


def main(argv=None):
    opt = parse_flags("Fault-tolerant serving fleet demo.", {
        "replicas": (3, "fleet size"),
        "requests": (12, "requests per act"),
        "maxNew": (12, "tokens to generate per request"),
        "seed": (0, "prompt RNG seed"),
        "device": ("cuda", "torch device; 'cpu' only when asked for"),
    }, argv)
    import numpy as np

    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.serve import Router
    from distlearn_tpu_torch.utils.checkpoint import save_checkpoint
    from distlearn_tpu_torch.utils.platform import resolve_device
    from distlearn_tpu_torch.utils.tree import tree_map

    device = resolve_device(opt.device)
    model = transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                           max_len=MAX_LEN)
    params = model.init(0, device="cpu")[0]
    rng = np.random.default_rng(opt.seed)

    def prompts(n):
        return [rng.integers(1, VOCAB, size=rng.integers(3, 9))
                .astype(np.int32) for _ in range(n)]

    ckpt_dir = tempfile.mkdtemp(prefix="serve_fleet_")
    servers = build_fleet(opt.replicas, params, ckpt_dir, device)
    router = Router([(s.host, s.port) for s in servers], health_ttl=0.05,
                    retry_interval=0.02)
    try:
        print(f"fleet up: {opt.replicas} replicas on {device} at "
              + ", ".join(f"{s.host}:{s.port}" for s in servers))

        # act 1: steady state
        report("steady", fire(router, prompts(opt.requests), opt.maxNew))

        # act 2: kill one replica mid-traffic; the router resubmits its
        # queued-not-prefilled requests to survivors
        victim = servers[0]
        res = fire(router, prompts(opt.requests), opt.maxNew,
                   kill_at=opt.requests // 2, kill=victim.stop)
        report("kill 1 replica", res)

        # act 3: hot swap — land a new checkpoint at epoch 2; survivors
        # tail it, swap between ticks, and echo the new epoch
        new_params = tree_map(lambda t: t * 0.5, params)
        save_checkpoint(ckpt_dir, 1, new_params, metadata={"epoch": 2})
        deadline = time.monotonic() + 30
        while any(s.epoch != 2 for s in servers[1:]):
            if time.monotonic() > deadline:
                raise SystemExit("hot swap never landed")
            time.sleep(0.05)
        res = fire(router, prompts(opt.requests), opt.maxNew)
        report("post hot-swap", res)
        if {r["epoch"] for r in res} != {2}:
            raise SystemExit("epoch fence violated")
        print("done: fleet survived a kill and an epoch-fenced hot swap")
    finally:
        router.close()
        for s in servers:
            s.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    main()
