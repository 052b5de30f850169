"""One EASGD loop over the three collective backends — the JAX package's
``examples/sync_backends.py`` on the port, with the same flags; ``--tpu``
becomes ``--device``.

The same :class:`~distlearn_tpu_torch.parallel.allreduce_ea.AllReduceEA`
loop runs over every topology of :mod:`~distlearn_tpu_torch.comm.backend`:

* ``--backend mesh``   — all N nodes are the rows of one ``MeshBackend``
  on the device, in this process.
* ``--backend host``   — every node its own TCP tree rank over localhost
  (the reference's torch-ipc topology; the ranks are threads here, each
  with its tensors on the device, staged through its tree's frame).
* ``--backend hybrid`` — N nodes split over ``--numHosts`` host ranks, each
  holding N/numHosts rows: the row sum, ONE TCP leg per host, the result
  back to every row.

The parameters are float64 with dyadic values and a dyadic ``alpha`` whose
center recursion stays contractive, so every sum is exact and the three
trajectories are bit for bit the same: the printed ``digest=`` line is the
same for every ``--backend``, and equal to the JAX example's for the same
flags.

    python -m distlearn_tpu_torch.examples.sync_backends --backend mesh \\
        --numNodes 8 [--device cpu]
    python -m distlearn_tpu_torch.examples.sync_backends --backend hybrid \\
        --numNodes 8 --numHosts 2
"""

from __future__ import annotations

import hashlib
import socket
import sys

import torch

from distlearn_tpu_torch.comm.backend import (HostBackend, HybridBackend,
                                              MeshBackend)
from distlearn_tpu_torch.comm.tree import tree_map_spawn
from distlearn_tpu_torch.parallel.allreduce_ea import AllReduceEA
from distlearn_tpu_torch.utils.flags import parse_flags
from distlearn_tpu_torch.utils.platform import resolve_device

FLAGS = {
    "backend": ("mesh", "mesh | host | hybrid"),
    "numNodes": (8, "logical nodes"),
    "numHosts": (2, "host ranks (hybrid only)"),
    "rounds": (20, "elastic rounds"),
    "tau": (1, "steps between averaging rounds"),
    "alpha": (0.0625, "elastic moving rate (dyadic AND contractive at N "
                      "nodes => bitwise across backends)"),
    "dim": (64, "parameter vector length"),
    "device": ("cuda", "torch device (replaces --tpu); 'cpu' only when "
                       "asked for"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _node_step(params: torch.Tensor, rank: int, r: int) -> torch.Tensor:
    """One deterministic dyadic 'gradient' step, standing in for a node's
    training step; exact in float64, so no reduction order can show."""
    g = (torch.arange(params.numel(), dtype=torch.float64,
                      device=params.device).reshape(params.shape)
         % 7 + rank + r) * 0.25
    return params - 0.5 * g


def run_rank(backend, local: int, rounds: int, tau: int, alpha: float,
             dim: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Drive ``local`` logical nodes' EASGD over one backend handle; returns
    ``(center, params)``.  A ``HostBackend`` sees one node and plain
    tensors, a stacked handle a ``[local, dim]`` slice."""
    ea = AllReduceEA(backend, tau, alpha)
    lo = backend.node_offset
    if backend.stacked_nodes is None:
        params = torch.zeros(dim, dtype=torch.float64, device=device)
        for r in range(rounds):
            params = ea.average_parameters(_node_step(params, lo, r))
    else:
        params = torch.zeros((local, dim), dtype=torch.float64,
                             device=device)
        for r in range(rounds):
            params = torch.stack([_node_step(params[i], lo + i, r)
                                  for i in range(local)])
            params = ea.average_parameters(params)
    return ea._center, params


def run(opt) -> str:
    """The run of ``opt``; returns the digest line."""
    device = resolve_device(opt.device)
    n, rounds = opt.numNodes, opt.rounds
    if opt.backend == "mesh":
        center, _ = run_rank(MeshBackend(n, device=device), n, rounds,
                             opt.tau, opt.alpha, opt.dim, device)
        center = center[0]
    elif opt.backend == "host":
        port = _free_port()

        def node(rank):
            b = HostBackend.create(rank, n, "127.0.0.1", port, base=2)
            try:
                return run_rank(b, 1, rounds, opt.tau, opt.alpha, opt.dim,
                                device)
            finally:
                b.close()
        center = tree_map_spawn(node, n, timeout=300)[0][0]
    elif opt.backend == "hybrid":
        hosts = opt.numHosts
        if n % hosts:
            raise SystemExit(f"--numNodes {n} not divisible by "
                             f"--numHosts {hosts}")
        local = n // hosts
        port = _free_port()

        def node(rank):
            b = HybridBackend(rank, hosts, "127.0.0.1", port,
                              num_devices=local, device=device)
            try:
                return run_rank(b, local, rounds, opt.tau, opt.alpha,
                                opt.dim, device)
            finally:
                b.close()
        center = tree_map_spawn(node, hosts, timeout=300)[0][0][0]
    else:
        raise SystemExit(f"unknown --backend {opt.backend!r}")
    center = center.detach().cpu().to(torch.float64).reshape(-1).numpy()
    digest = hashlib.sha256(center.tobytes()).hexdigest()[:16]
    return (f"backend={opt.backend} nodes={n} rounds={rounds} "
            f"center[0:4]={center[:4].tolist()} digest={digest}")


def main(argv=None) -> int:
    opt = parse_flags("EASGD over the topology-aware collective backends.",
                      FLAGS, argv)
    print(run(opt), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
