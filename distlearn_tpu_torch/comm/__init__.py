"""Host communication of the port (counterparts of ``distlearn_tpu/comm``):
the packed wire codec, the framed TCP transport and its error types, the
tree and ring collectives over it (numpy leaves, or torch tensors staged
through a pinned frame), their shared base, deterministic fault
injection, and the collective backends (``HostBackend``, ``MeshBackend``,
``HybridBackend``) one sync API spans."""

from distlearn_tpu_torch.comm import errors, transport, wire
from distlearn_tpu_torch.comm.backend import (CollectiveBackend, HostBackend,
                                              HostCollectiveBase,
                                              HybridBackend, MeshBackend,
                                              plan_chunks)
from distlearn_tpu_torch.comm.errors import PeerClosed
from distlearn_tpu_torch.comm.faults import FaultInjected, FaultPlan
from distlearn_tpu_torch.comm.ring import LocalhostRing, Ring
from distlearn_tpu_torch.comm.transport import (Conn, ProtocolError, Server,
                                                connect)
from distlearn_tpu_torch.comm.tree import LocalhostTree, Tree, tree_map_spawn

__all__ = ["errors", "transport", "wire", "PeerClosed", "Conn",
           "ProtocolError", "Server", "connect", "Ring", "LocalhostRing",
           "Tree", "LocalhostTree", "tree_map_spawn", "FaultPlan",
           "FaultInjected", "HostCollectiveBase", "CollectiveBackend",
           "HostBackend", "MeshBackend", "HybridBackend", "plan_chunks"]
