"""The plain models that decide ``correct``, one module a model family.

A configuration names its module (``"reference": "resnet"``); each module
gives ``param_specs(cfg)``, ``state_init(cfg, device)`` and ``loss(cfg,
params, state, x, y, gen, precision, terms)``.  Plain PyTorch, float32, TF32 off;
nothing here imports ``jax``, the JAX package or the port.
"""

from __future__ import annotations

import importlib
from types import ModuleType


def model(cfg: dict) -> ModuleType:
    """The reference module ``cfg["reference"]`` names."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")
