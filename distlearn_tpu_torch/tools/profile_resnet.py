"""Capture a ``torch.profiler`` trace of the port's ResNet-50 fused SGD step.

The port's counterpart of the root ``tools/profile_resnet.py``: the same
flags (``log_dir``, ``--batch``, ``--steps``), over
``train/trainer.py::build_sgd_step`` on a one-rank mesh, its gradients in
16-MiB buckets (8, as the ``resnet50`` example's: 8 launches of B1 a
step), bfloat16 compute on the card and float32 on the CPU, as the JAX
tool chooses by platform.  The trace goes through ``utils/profiling.py::trace``
(a settled window) to ``<log_dir>/trace.json``; read it with
``tools.analyze_trace``.

Usage:
    python -m distlearn_tpu_torch.tools.profile_resnet /tmp/prof_resnet [--batch 256] [--steps 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

WARMUP = 3                      # steps before the trace opens (JAX's)
BUCKET_BYTES = 16 * 2 ** 20     # the resnet50 example's gradient buckets
IMAGE_SIZE = 224


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the step's device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from distlearn_tpu_torch.models.resnet import resnet50
    from distlearn_tpu_torch.ops import fused_update
    from distlearn_tpu_torch.parallel.mesh import init_mesh, local_init_method
    from distlearn_tpu_torch.train.trainer import (build_sgd_step,
                                                   init_train_state)
    from distlearn_tpu_torch.utils.platform import resolve_device
    from distlearn_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    tree = init_mesh(0, 1, init_method=local_init_method(), device=device)
    try:
        model = resnet50(1000,
                         compute_dtype=torch.bfloat16 if cuda else None)
        ts = init_train_state(model, tree, 0, 1000)
        step = build_sgd_step(model, tree, lr=0.1,
                              max_bucket_bytes=BUCKET_BYTES)
        rs = np.random.RandomState(0)
        bx = torch.from_numpy(rs.randn(args.batch, IMAGE_SIZE, IMAGE_SIZE, 3)
                              .astype(np.float32)).to(device)
        by = torch.from_numpy(rs.randint(0, 1000, (args.batch,))
                              .astype(np.int64)).to(device)
        for _ in range(WARMUP):
            ts, loss = step(ts, bx, by)
        if cuda:
            torch.cuda.synchronize(device)
        before = fused_update.fused_sgd.launches
        with trace(args.log_dir, device):
            for _ in range(args.steps):
                ts, loss = step(ts, bx, by)
            if cuda:
                torch.cuda.synchronize(device)
        launches = fused_update.fused_sgd.launches - before
        print(f"trace written to {args.log_dir} ({args.steps} steps, "
              f"batch {args.batch}, {IMAGE_SIZE}^2, "
              f"{'bfloat16' if cuda else 'float32'} compute on {device}, "
              f"B1 {launches} launches, final loss {float(loss):.4f})")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
