"""Command-line client for a serving endpoint — a copy of the JAX package's
``examples/lm_client.py`` over the port's :class:`ServeClient`; it drives
a port server (``python -m distlearn_tpu_torch.examples.lm --serve``) and a
JAX one alike.

Dials the serving port, submits one or more generate requests over the
'G'/'R' framed protocol (docs/SERVING.md), streams tokens as they
arrive, and reports per-request time-to-first-token and aggregate
throughput.  ``--concurrency N`` opens N connections and submits in
parallel — the server's continuous batching packs them into one decode
tick, so aggregate tok/s should scale well past a single request's.

    python -m distlearn_tpu_torch.examples.lm --steps 0 --serve 4 \
        --servePort 9123 &
    python -m distlearn_tpu_torch.examples.lm_client --port 9123 \
        --concurrency 4
"""

from __future__ import annotations

import sys
import threading
import time

from distlearn_tpu_torch.utils.flags import parse_flags


def main(argv=None):
    opt = parse_flags("Drive a distlearn_tpu serving endpoint.", {
        "host": ("127.0.0.1", "serving host"),
        "port": (0, "serving port (required; printed by lm.py --serve)"),
        "prompt": ("", "comma-separated token ids (empty = a fixed "
                       "8-token demo prompt)"),
        "maxNew": (16, "tokens to generate per request"),
        "concurrency": (1, "parallel requests, one connection each"),
        "deadline": (0.0, "per-request deadline seconds (0 = none; the "
                          "server evicts requests that exceed it)"),
        "ping": (False, "just print the server's health snapshot and exit"),
    }, argv)
    if not opt.port:
        raise SystemExit("--port is required (lm.py --serve prints it)")
    from distlearn_tpu_torch.serve import ServeClient

    if opt.ping:
        with ServeClient(opt.host, opt.port) as c:
            print(c.ping())
        return

    if opt.prompt:
        prompt = [int(t) for t in opt.prompt.split(",")]
    else:
        prompt = [1, 7, 3, 9, 2, 8, 4, 6]

    results: dict[int, dict] = {}
    t0 = time.perf_counter()

    def run(i: int):
        with ServeClient(opt.host, opt.port) as c:
            ts = time.perf_counter()
            ttft = [None]

            def on_chunk(_toks, _t=ts):
                if ttft[0] is None:
                    ttft[0] = time.perf_counter() - _t
            r = c.generate(prompt, opt.maxNew, rid=f"req{i}",
                           deadline_s=opt.deadline or None,
                           on_chunk=on_chunk)
            results[i] = {"tokens": r["tokens"], "ttft": ttft[0],
                          "reason": r["reason"]}

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(opt.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total = 0
    for i in sorted(results):
        r = results[i]
        total += len(r["tokens"])
        print(f"req{i}: {len(r['tokens'])} tokens "
              f"(ttft {r['ttft'] * 1e3:.1f}ms, {r['reason']}): "
              f"{r['tokens']}")
    if len(results) < opt.concurrency:
        print(f"{opt.concurrency - len(results)} request(s) failed",
              file=sys.stderr)
        sys.exit(1)
    print(f"{total} tokens over {len(results)} request(s) in "
          f"{wall:.2f}s = {total / wall:.1f} tok/s aggregate")


if __name__ == "__main__":
    main()
