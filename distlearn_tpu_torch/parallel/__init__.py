"""Data-parallel sync algorithms: over ``torch.distributed`` (the mesh of
``parallel/mesh.py``), and the reference's host-side AllReduceSGD/EA over
the TCP tree or ring (``parallel/host_algorithms.py``)."""

from distlearn_tpu_torch.parallel.host_algorithms import (TreeAllReduceEA,
                                                          TreeAllReduceSGD)

__all__ = ["TreeAllReduceSGD", "TreeAllReduceEA"]
