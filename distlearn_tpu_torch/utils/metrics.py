"""Training metrics: the confusion matrix the reference keeps with
optim.ConfusionMatrix (examples/mnist.lua:95,110,120-125), held on the
device and summed across nodes at report time.  Counterpart of
``distlearn_tpu/utils/metrics.py``."""

from __future__ import annotations

import numpy as np
import torch


def init_confusion(num_classes: int, device) -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device)


def update_confusion(cm: torch.Tensor, log_probs: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """``cm[target, prediction] += 1`` per example (rows are targets,
    columns predictions).  Returns a new matrix."""
    num_classes = cm.shape[0]
    preds = torch.argmax(log_probs, dim=-1)
    idx = labels.to(torch.int64) * num_classes + preds
    # index_add_, not bincount: bincount sizes its output from the data,
    # which waits on the device.
    flat = cm.reshape(-1).clone()
    flat.index_add_(0, idx, torch.ones_like(idx, dtype=cm.dtype))
    return flat.view(num_classes, num_classes)


def all_reduce_confusion(cm: torch.Tensor, tree) -> torch.Tensor:
    """The global matrix across the nodes of ``tree`` (a
    :class:`~distlearn_tpu_torch.parallel.mesh.MeshTree`; ref
    examples/mnist.lua:122)."""
    return tree.all_reduce(cm)[0]


def total_valid(cm) -> float:
    """``totalValid``: trace / total — global accuracy."""
    cm = np.asarray(cm.cpu() if isinstance(cm, torch.Tensor) else cm)
    tot = cm.sum()
    return float(np.trace(cm) / tot) if tot else 0.0
