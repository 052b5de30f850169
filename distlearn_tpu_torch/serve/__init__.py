"""The decode service of the port — counterpart of ``distlearn_tpu/serve``:
continuous batching (requests join and leave the running batch between
decode ticks) over a fixed-slot paged KV cache on the card.

Layers, bottom up: ``kv_cache`` (host-side slot/page bookkeeping),
``engine`` (:class:`DecodeEngine`: bucketed prefill with kernel B5a, the
batched decode tick, chunked prefill and speculative verify; tensor
parallel as a leader rank and follower ranks), ``prefix_cache`` and
``speculate``, ``scheduler`` (admission, ticking, eviction), ``server`` /
``client`` ('G'/'R' frames, byte-compatible with the JAX package's, so
either package's client drives either server), ``router``
(:class:`Router`: health-routed dispatch over a fleet of replicas of
either package, retry on death, shedding, hedging, the epoch fence).

Demo: ``python -m distlearn_tpu_torch.examples.lm --steps 0 --serve 4``
(``--tp 2``: one leader and one follower rank) and ``python -m
distlearn_tpu_torch.examples.lm_client --port P``; the fleet:
``python -m distlearn_tpu_torch.examples.serve_fleet``.
"""

from distlearn_tpu_torch.serve.client import (ReplicaDead, ServeClient,
                                              ServeError)
from distlearn_tpu_torch.serve.engine import DecodeEngine
from distlearn_tpu_torch.serve.kv_cache import CacheFull, PagedKVCache
from distlearn_tpu_torch.serve.router import Router, RouterBusy
from distlearn_tpu_torch.serve.scheduler import (Event, QueueFull, Request,
                                                 Scheduler)
from distlearn_tpu_torch.serve.server import ServeServer, WeightTailer

__all__ = [
    "CacheFull", "DecodeEngine", "Event", "PagedKVCache", "QueueFull",
    "ReplicaDead", "Request", "Router", "RouterBusy", "Scheduler",
    "ServeClient", "ServeError",
    "ServeServer", "WeightTailer",
]
