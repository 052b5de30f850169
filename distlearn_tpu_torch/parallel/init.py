"""Multi-process bootstrap — counterpart of ``distlearn_tpu/parallel/init.py``.

The reference runs across machines by hand-wiring sockets: node 1 calls
``ipc.server``, every other host dials it, and each passes the resulting
server/client into ``ipc.Tree`` (examples/client_remote.lua:34-41).  The JAX
package joins one multi-process XLA runtime (``jax.distributed``); here
every process dials one ``torch.distributed`` rendezvous over TCP, after
which the default process group spans them all and the train steps
(``train/trainer.py``) run on its :class:`~distlearn_tpu_torch.parallel.
mesh.MeshTree` unchanged.

Two deployment shapes, mirroring the reference's two:

* **Process group** (this module): NCCL on the cards, one card a process,
  or gloo on the CPU; each process feeds its own shard of the global batch
  (:func:`host_local_batch`).
* **Process-per-node over the TCP tree**
  (``examples/client_remote.py``): each process trains on its own and
  syncs through ``parallel/host_algorithms.py`` — the reference's own
  topology, for processes without a shared collective runtime.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from distlearn_tpu_torch.parallel.mesh import MeshTree
from distlearn_tpu_torch.utils.platform import resolve_device


@dataclass(frozen=True)
class ProcessInfo:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    device: torch.device

    @property
    def is_root(self) -> bool:
        return self.process_id == 0


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=None) -> ProcessInfo:
    """Join (or create) the process group.

    ``coordinator`` is the rendezvous ``host:port`` every process dials (a
    ``tcp://`` init method); each argument falls back to the
    ``DISTLEARN_COORDINATOR`` / ``DISTLEARN_NUM_PROCESSES`` /
    ``DISTLEARN_PROCESS_ID`` environment variables.  Nothing here finds a
    cluster by itself: a missing value raises.

    ``device``: the card by default — NCCL, one card a process, process
    ``i`` on ``cuda:i % cards`` unless ``device`` names one; ``"cpu"``
    joins over gloo.  Each process holds one device, so ``local_devices``
    is 1 and ``global_devices`` the number of processes.
    """
    coordinator = coordinator or os.environ.get("DISTLEARN_COORDINATOR")
    if num_processes is None and "DISTLEARN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DISTLEARN_NUM_PROCESSES"])
    if process_id is None and "DISTLEARN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DISTLEARN_PROCESS_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator, the number of "
                         "processes and this process's id (arguments or "
                         "DISTLEARN_COORDINATOR / DISTLEARN_NUM_PROCESSES / "
                         "DISTLEARN_PROCESS_ID)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if device is None or torch.device(device).index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    init_method = coordinator if "://" in coordinator \
        else f"tcp://{coordinator}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return ProcessInfo(process_id=dist.get_rank(),
                       num_processes=dist.get_world_size(),
                       local_devices=1,
                       global_devices=dist.get_world_size(),
                       device=dev)


def global_mesh_tree() -> MeshTree:
    """A :class:`MeshTree` over the default group of every joined process
    — the pod-scale ``tree`` handle: ``num_nodes`` is the number of
    processes, and this process's node lives on the device
    :func:`initialize` chose (the current card under NCCL, the CPU under
    gloo)."""
    backend = dist.get_backend()
    if backend == "nccl":
        return MeshTree(device=torch.device("cuda",
                                            torch.cuda.current_device()))
    return MeshTree(device="cpu")


def host_local_batch(tree: MeshTree, array) -> torch.Tensor:
    """This process's shard of a global batch, on its node's device.

    Each process passes its local slice (leading axis = per-process batch),
    as in the JAX package; where JAX assembles one global array sharded
    over the mesh, a port process simply holds its shard — the collectives
    of :class:`MeshTree` combine the nodes."""
    return torch.as_tensor(array, device=tree.device)
