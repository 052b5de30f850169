"""The system under test: ``distlearn_tpu_torch``'s AllReduceSGD step, built
as its examples build it (``examples/resnet50.py::train``) from what a
configuration states.

The benchmark hands the program its weights and its dropout generator,
both made from the seed (:func:`portbench.reference.common.make_params`),
so the reference starts from the same state without reading the
program's.
"""

from __future__ import annotations

import inspect

import torch

from portbench.reference.common import generator, leaves, make_params

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class System:
    """One rank's step, its epoch-end sync and its state."""

    def __init__(self, cfg: dict, seed: int, device, specs: list):
        from distlearn_tpu_torch import models
        from distlearn_tpu_torch.parallel.mesh import (MeshTree, init_mesh,
                                                       local_init_method)
        from distlearn_tpu_torch.train import (build_sgd_step,
                                               build_sync_step,
                                               init_train_state)
        import torch.distributed as dist

        if not dist.is_initialized():
            init_mesh(0, 1, init_method=local_init_method(), device=device)
        self.tree = MeshTree(device=device)
        compute = DTYPES[cfg["compute_dtype"]]
        self.model = program_model(
            models, cfg, compute_dtype=None if compute == torch.float32
            else compute)
        ts = init_train_state(self.model, self.tree, seed,
                              cfg["num_classes"])
        params = make_params(specs, seed, device)
        _same_layout(ts.params, params)
        self.ts = ts._replace(params=params,
                              rng=generator(seed, "dropout", device))
        opt = cfg["optimizer"]
        mib = opt["bucket_mib"]
        self.bucket_bytes = mib * 1024 * 1024 if mib else None
        self.step = build_sgd_step(self.model, self.tree, lr=opt["lr"],
                                   max_bucket_bytes=self.bucket_bytes)
        self.sync = build_sync_step(self.tree)

    @property
    def params(self) -> dict:
        return self.ts.params

    @property
    def state(self) -> dict:
        return self.ts.model_state

    def train(self, x, y):
        """One step; returns its loss (a device scalar)."""
        self.ts, loss = self.step(self.ts, x, y)
        return loss

    def epoch_end(self):
        self.ts = self.sync(self.ts)


def program_model(models, cfg: dict, **kw):
    """The port's model that ``cfg["program"]`` names, given ``kw`` and
    each other keyword argument of it that the configuration states at its
    top level."""
    fn = getattr(models, cfg["program"])
    stated = {k: cfg[k] for k in inspect.signature(fn).parameters
              if k in cfg and k not in kw}
    return fn(**stated, **kw)


def _same_layout(program: dict, bench: dict) -> None:
    """The benchmark's weights have the program's keys and shapes."""
    a = [(p, tuple(t.shape)) for p, t in leaves(program)]
    b = [(p, tuple(t.shape)) for p, t in leaves(bench)]
    if a != b:
        diff = sorted(set(a) ^ set(b))[:6]
        raise ValueError(f"the configuration's parameters differ from the "
                         f"program's model: {diff}")


def close() -> None:
    """Ends the process group the system started."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
