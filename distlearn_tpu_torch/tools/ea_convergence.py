"""EASGD-vs-SGD convergence evidence: loss-vs-WALL-CLOCK curves, on the port.

The port's counterpart of the root ``tools/ea_convergence.py``: the same
flags, runs and output, with the MLP and its hand-written gradients in
torch on ``--device`` (the card unless ``cpu`` is asked for).

* N localhost ranks (threads of this process) train the same small MLP
  on the NON-separable synthetic task (``data.synthetic_hard``) through
  the host TCP tree backend, the reference's own deployment shape; each
  rank's leaves stay on its device and stage through the tree's frame.
* Every link is paced to an emulated NIC bandwidth
  (``Conn.throttle_bps``) so communication has a real price.
* Algorithms at EQUAL wall-clock budget: synchronous AllReduceSGD
  (gradient allreduce every step) vs AllReduceEA (``tau`` local steps
  per elastic round, B2 once a rank each round on the card) at several
  (tau, alpha) points.

Output: one JSONL curve file per run under ``--out`` (plot with
``tools/plot_errors.py``) and a summary table on stdout:

    python -m distlearn_tpu_torch.tools.ea_convergence --budget 12 --ranks 4 --linkMBs 20 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from contextlib import closing

import numpy as np
import torch

from distlearn_tpu_torch.comm.tree import LocalhostTree, tree_map_spawn
from distlearn_tpu_torch.data import synthetic_hard
from distlearn_tpu_torch.parallel.host_algorithms import (TreeAllReduceEA,
                                                          TreeAllReduceSGD)
from distlearn_tpu_torch.utils.platform import resolve_device


def init_mlp(d_in, hidden, classes, seed, device="cpu"):
    """The JAX tool's initial MLP (the same numpy draws) on ``device``."""
    r = np.random.RandomState(seed)
    s1, s2 = (2.0 / d_in) ** 0.5, (2.0 / hidden) ** 0.5
    p = {"w1": (r.randn(d_in, hidden) * s1).astype(np.float32),
         "b1": np.zeros(hidden, np.float32),
         "w2": (r.randn(hidden, classes) * s2).astype(np.float32),
         "b2": np.zeros(classes, np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in p.items()}


def mlp_loss_grads(p, x, y):
    """Mean cross-entropy of the ReLU MLP and its hand-written gradients
    (the JAX tool's math).  Returns ``(loss, grads)``, the loss a 0-d
    tensor on the params' device."""
    h_pre = x @ p["w1"] + p["b1"]
    h = torch.clamp_min(h_pre, 0.0)
    logits = h @ p["w2"] + p["b2"]
    logits = logits - logits.max(1, keepdim=True).values
    e = torch.exp(logits)
    probs = e / e.sum(1, keepdim=True)
    n = len(y)
    rows = torch.arange(n, device=x.device)
    loss = -torch.log(probs[rows, y] + 1e-12).mean()
    d = probs
    d[rows, y] -= 1.0
    d /= n
    dh = (d @ p["w2"].T) * (h_pre > 0)
    g = {"w2": h.T @ d, "b2": d.sum(0), "w1": x.T @ dh, "b1": dh.sum(0)}
    return loss, g


def _throttle(tree, bps):
    for c in ([tree._parent] if tree._parent else []) + list(tree._kids):
        c.throttle_bps = bps


def run_algo(algo, ranks, budget, port, bps, tau=1, alpha=0.5, lr=0.2,
             batch=64, seed=0, hidden=256, device=None):
    """Train for ``budget`` seconds; returns the per-rank results list
    ``[(curve, final_loss, elastic_rounds), ...]`` where ``curve`` is
    ``[(t, train_loss, step), ...]`` and ``elastic_rounds`` the rank's EA
    rounds, flush rounds included (0 for SGD)."""
    device = resolve_device(device)
    side = 16
    xs, ys = synthetic_hard(4096, (side, side, 1), 4, seed=seed,
                            label_noise=0.05)
    xs = torch.from_numpy(xs.reshape(len(xs), -1)).to(device)
    ys = torch.from_numpy(ys.astype(np.int64)).to(device)

    def node(rank):
        tree = LocalhostTree(rank, ranks, port, base=2)
        if bps:
            _throttle(tree, bps)
        sgd = TreeAllReduceSGD(tree)
        ea = TreeAllReduceEA(tree, tau, alpha) if algo == "ea" else None
        p = init_mlp(side * side, hidden, 4, seed=7,
                     device=device)                    # identical init
        rng = np.random.RandomState(100 + rank)
        curve = []
        t0 = time.time()
        step = 0
        while time.time() - t0 < budget:
            idx = torch.from_numpy(rng.randint(0, len(xs), batch)).to(device)
            loss, g = mlp_loss_grads(p, xs[idx], ys[idx])
            if algo == "sgd":
                g, nc = sgd.sum_and_normalize_gradients(g)
            for k in p:
                p[k] -= lr * g[k]
            if algo == "ea":
                p = ea.average_parameters(p)
            step += 1
            if step % 5 == 0:
                curve.append((time.time() - t0, float(loss), step))
        if algo == "ea":
            p = ea.synchronize_parameters(p)
        else:
            p = sgd.synchronize_parameters(p)
        final, _ = mlp_loss_grads(p, xs[:2048], ys[:2048])
        tree.close()
        return curve, float(final), ea.rounds if ea is not None else 0

    return tree_map_spawn(node, ranks, timeout=budget * 10 + 120)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--budget", type=float, default=12.0,
                    help="wall-clock seconds per run")
    ap.add_argument("--linkMBs", type=float, default=20.0,
                    help="emulated per-link MB/s (0 = raw loopback)")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--out", default="docs/ea_curves")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    bps = args.linkMBs * 1e6 if args.linkMBs else None

    def port():
        with closing(socket.socket()) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    runs = [("sgd", {}),
            ("ea", {"tau": 4, "alpha": 0.225}),    # beta=0.9: alpha=beta/tau
            ("ea", {"tau": 16, "alpha": 0.056}),
            ("ea", {"tau": 16, "alpha": 0.4})]     # deliberately aggressive
    rows = []
    for algo, kw in runs:
        tag = algo + "".join(f"_{k}{v}" for k, v in kw.items())
        res = run_algo(algo, args.ranks, args.budget, port(), bps,
                       lr=args.lr, device=args.device, **kw)
        curve0 = res[0][0]
        finals = [f for _, f, _ in res]
        steps = max(c[-1][2] if c else 0 for c, _, _ in res)
        path = os.path.join(args.out, f"{tag}.jsonl")
        with open(path, "w") as fh:
            for t, loss, step in curve0:
                fh.write(json.dumps({"round": step, "t": round(t, 3),
                                     "train_err": round(loss, 4)}) + "\n")
        rows.append((tag, steps, float(np.mean(finals))))
        print(f"{tag:24s} steps/rank={steps:6d} "
              f"final_loss={np.mean(finals):.4f}  -> {path}")

    print("\n| run | local steps/rank | final loss (equal wall-clock,"
          f" {args.budget:.0f}s, {args.ranks} ranks, "
          f"{args.linkMBs:.0f} MB/s links) |")
    print("|---|---|---|")
    for tag, steps, final in rows:
        print(f"| {tag} | {steps} | {final:.4f} |")


if __name__ == "__main__":
    main()
