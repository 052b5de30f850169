"""Model container — counterpart of ``distlearn_tpu/models/core.py``, the
reference's ``{params, f, df}`` export (examples/Model.lua:81-85).  The
gradient (the reference's ``df``) comes from ``torch.autograd``."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from distlearn_tpu_torch.models import nn
from distlearn_tpu_torch.utils.tree import tree_leaves

PyTree = Any


class Model(NamedTuple):
    """``init(seed, device) -> (params, state)``;
    ``apply(params, state, x, train, rng, tree, bn_weight) ->
    (log_probs, new_state)`` with ``x`` NHWC.

    ``state`` holds the batchnorm running statistics (empty when none);
    ``tree`` turns on sync batchnorm over its nodes; ``rng`` is the
    dropout generator."""
    init: Callable[..., tuple[PyTree, PyTree]]
    apply: Callable[..., tuple[Any, PyTree]]
    name: str
    input_shape: tuple[int, ...]   # per example, NHWC, e.g. (32, 32, 3)
    num_classes: int


def loss_fn(model: Model, params: PyTree, state: PyTree, x, y,
            train: bool = True, rng=None, tree=None, bn_weight=None):
    """NLL over log-softmax outputs (ref examples/Model.lua:50-61).
    Returns ``(loss, (log_probs, new_state))``."""
    log_probs, new_state = model.apply(params, state, x, train=train, rng=rng,
                                       tree=tree, bn_weight=bn_weight)
    return nn.nll_loss(log_probs, y), (log_probs, new_state)


def param_count(params: PyTree) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
