"""Expert parallelism: a routed mixture-of-experts layer over a mesh axis —
counterpart of ``distlearn_tpu/parallel/ep.py`` (GShard/Switch).

* Routing (per rank, local tokens): a linear router picks each token's
  top-k experts; assignments past an expert's capacity are dropped (their
  combine weight is zero, the output falls back to the residual stream).
* Dispatch and combine are einsums over a boolean dispatch mask and float
  combine weights ``[N, E, C]``: no dynamic shapes and no sorting of
  tokens.
* Over the expert axis each rank owns one expert: the buckets ``[E, C,
  D]`` go through an all-to-all, so rank ``e`` holds every peer's bucket
  for expert ``e`` and applies its FFN to ``E*C`` tokens at once, and the
  reverse all-to-all brings the results home.

Top-k ties go to the lower expert index, as ``lax.top_k`` breaks them (a
stable descending sort), and the slot positions count in int32.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from distlearn_tpu_torch.parallel.mesh import MeshAxis, all_to_all
from distlearn_tpu_torch.utils.tree import tree_map

PyTree = Any


def _top_k(gates: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties broken
    towards the lower index."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(router_logits: torch.Tensor, capacity: int, k: int = 1):
    """Top-k routing with capacity (k=1: Switch; k=2: GShard).

    Returns ``(dispatch, combine, aux)``: dispatch ``[N, E, C]`` bool
    (token n holds slot c of expert e), combine ``[N, E, C]`` float32 (the
    gate weight there: the raw top-1 gate for k=1, the chosen gates
    renormalised over the k picks otherwise; zero for a dropped
    assignment), and aux ``{"balance_loss", "dropped_frac"}``: the Switch
    load-balancing loss ``E * sum_e f_e * P_e`` (``f_e`` the fraction of
    tokens whose first choice is e, ``P_e`` the mean gate of e; 1.0 at
    perfect balance) and the fraction of the ``N*k`` assignments dropped.
    Slots are claimed in rank order: every token's first choice before
    any token's second."""
    N, E = router_logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"top-k routing needs 1 <= k <= num_experts, "
                         f"got k={k} with {E} experts")
    dev = router_logits.device
    gates = torch.softmax(router_logits.float(), dim=-1)
    topv, topi = _top_k(gates, k)
    if k == 1:
        weights = topv
    else:
        weights = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    dispatch3 = torch.zeros((N, E, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((N, E, capacity), dtype=torch.float32, device=dev)
    counts = torch.zeros((E,), dtype=torch.int32, device=dev)
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    for j in range(k):
        onehot = torch.nn.functional.one_hot(topi[:, j], E) \
            .to(torch.int32)                                   # [N, E]
        pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32)
               + counts[None, :]) * onehot - 1
        disp = (onehot > 0) & (pos < capacity)                 # kept?
        d3 = (pos[..., None] == slots) & disp[..., None]       # [N, E, C]
        dispatch3 = dispatch3 | d3
        combine = combine + d3.float() * weights[:, j][:, None, None]
        counts = counts + onehot.sum(0, dtype=torch.int32)
        if j == 0:
            frac_tokens = onehot.float().mean(0)
    frac_probs = gates.mean(0)
    aux = {"balance_loss": E * torch.sum(frac_tokens * frac_probs),
           "dropped_frac": 1.0 - dispatch3.float().sum() / (N * k)}
    return dispatch3, combine, aux


def route_top1(router_logits: torch.Tensor, capacity: int):
    """:func:`route_topk` with k=1, aux dropped: ``(dispatch, combine)``."""
    dispatch, combine, _ = route_topk(router_logits, capacity, k=1)
    return dispatch, combine


def _route_and_bucket(router_w: torch.Tensor, x: torch.Tensor,
                      capacity_factor: float, E: int, top_k: int = 1):
    """The routing prologue shared by :func:`moe_ffn_local` and
    :func:`moe_ffn`: capacity, masks, the per-expert token buckets ``[E,
    C, D]`` and the aux terms."""
    N, _ = x.shape
    capacity = max(1, int(-(-N * capacity_factor * top_k // E)))
    logits = x.float() @ router_w.float()
    dispatch, combine, aux = route_topk(logits, capacity, top_k)
    buckets = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), x)
    return combine, buckets, capacity, aux


def _combine(combine_w: torch.Tensor, expert_out: torch.Tensor
             ) -> torch.Tensor:
    return torch.einsum("nec,ecd->nd", combine_w.to(expert_out.dtype),
                        expert_out)


def moe_ffn_local(expert_fn: Callable, stacked_params: PyTree,
                  router_w: torch.Tensor, x: torch.Tensor,
                  capacity_factor: float = 1.25, top_k: int = 1,
                  return_aux: bool = False):
    """Mixture of experts with every expert on this rank: the routing of
    :func:`moe_ffn` without the all-to-alls, the experts applied one after
    another (``stacked_params`` leaves carry a leading ``[E]`` axis;
    ``expert_fn(params_e, tokens)`` applies one).  The no-expert-axis path
    of MoE models and the oracle of the distributed one."""
    E = router_w.shape[1]
    combine, buckets, _, aux = _route_and_bucket(router_w, x,
                                                 capacity_factor, E, top_k)
    out = torch.stack([
        expert_fn(tree_map(lambda a, e=e: a[e], stacked_params), buckets[e])
        for e in range(E)])                                    # [E, C, D]
    y = _combine(combine, out)
    return (y, aux) if return_aux else y


def moe_ffn(expert_fn: Callable, expert_params: PyTree,
            router_w: torch.Tensor, x: torch.Tensor,
            capacity_factor: float = 1.25, axis: MeshAxis | None = None,
            top_k: int = 1, return_aux: bool = False):
    """Expert-parallel mixture of experts, one expert per rank of ``axis``.

    ``expert_fn(params, tokens)`` is this rank's expert on ``[E*C, D]``
    tokens; ``router_w`` ``[D, E]`` is replicated, so every rank routes
    alike; ``x`` is this rank's tokens ``[N, D]``.  Returns ``[N, D]``
    (dropped assignments contribute zeros; add the residual outside), and
    the aux dict of :func:`route_topk` for the local tokens with
    ``return_aux``."""
    if axis is None:
        raise ValueError("moe_ffn needs the expert axis (a MeshAxis)")
    E = axis.size
    N, D = x.shape
    if tuple(router_w.shape) != (D, E):
        raise ValueError(
            f"router_w must be [{D}, {E}] (token dim x expert-axis size, "
            f"one expert per device), got {tuple(router_w.shape)}")
    combine, buckets, capacity, aux = _route_and_bucket(
        router_w, x, capacity_factor, E, top_k)
    recv = all_to_all(buckets, axis, 0, 0)
    out = expert_fn(expert_params, recv.reshape(E * capacity, D))
    home = all_to_all(out.reshape(E, capacity, D), axis, 0, 0)
    y = _combine(combine, home)
    return (y, aux) if return_aux else y
