"""The port's entry points for a quick check — counterpart of the root
``__graft_entry__.py`` of the JAX package.

``entry()``             the CIFAR-10 convnet's eval forward at batch 8 (the
                        reference's headline model, examples/cifar10.lua),
                        on the card unless ``device="cpu"``.
``dryrun_multichip(n)`` ``n`` gloo ranks on the CPU (the JAX package runs
                        ``n`` virtual CPU devices): the AllReduceSGD step
                        and the end-of-epoch sync, one EASGD local step and
                        round, the scanned SGD step and the EASGD cycle,
                        and the transformer LM's step over the data axis;
                        it prints and returns the parts of the JAX dry run
                        that wait for later ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import torch

#: The JAX dry run's parts the port does not run yet, with their ROADMAP
#: item.
WAITING = {
    "lm over a dp x sp x tp mesh (ring attention, Megatron tp)":
        "ROADMAP A11",
    "zigzag sequence layout": "ROADMAP A11",
    "ZeRO-1 with tp and sp": "ROADMAP A11",
    "ZeRO-3 / FSDP": "ROADMAP A11",
    "pipeline-parallel LM (GPipe)": "ROADMAP A11",
    "MoE over an expert axis": "ROADMAP A11",
}


def entry(device=None):
    """Returns ``(fn, example_args)`` with ``fn(*example_args)`` the
    log-probs of a batch of 8 on ``device`` (the card unless the CPU is
    asked for); ``fn(params, x)`` takes the convnet's params (seed 0) and
    an NHWC batch."""
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.utils.platform import resolve_device
    device = resolve_device(device)
    model = cifar_convnet(dropout_rate=0.0)
    params, state = model.init(0, device)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 32, 32, 3)
                         .astype(np.float32)).to(device)

    @torch.no_grad()
    def fn(p, xx):
        log_probs, _ = model.apply(p, state, xx, train=False)
        return log_probs

    return fn, (params, x)


def _dryrun_rank(rank: int, n: int, init_method: str, results) -> None:
    import torch.distributed as dist

    from distlearn_tpu_torch.data import synthetic_cifar10
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.parallel.mesh import init_mesh
    from distlearn_tpu_torch.train import (build_ea_cycle, build_ea_steps,
                                           build_lm_step,
                                           build_sgd_scan_step,
                                           build_sgd_step, build_sync_step,
                                           init_ea_state, init_train_state)
    torch.set_num_threads(1)
    tree = init_mesh(rank, n, init_method=init_method, device="cpu")
    try:
        model = cifar_convnet(dropout_rate=0.0)
        x, y, nc = synthetic_cifar10(4 * n, seed=0)   # 2 a node, 2 steps
        xs = x.reshape(2, n, 2, 32, 32, 3)[:, rank]
        ys = y.reshape(2, n, 2)[:, rank]
        out = {}
        ts = init_train_state(model, tree, 0, nc)
        ts, loss = build_sgd_step(model, tree, lr=0.1)(ts, xs[0], ys[0])
        ts = build_sync_step(tree)(ts)
        out["sgd_loss"] = float(loss)
        ets = init_ea_state(model, tree, 0, nc)
        local, rnd = build_ea_steps(model, tree, lr=0.1, alpha=0.2)
        ets, loss = local(ets, xs[0], ys[0])
        ets = rnd(ets)
        out["ea_loss"] = float(loss)
        _, losses = build_sgd_scan_step(model, tree, lr=0.1)(
            init_train_state(model, tree, 0, nc), xs, ys)
        out["scan_losses"] = losses.tolist()
        _, losses = build_ea_cycle(model, tree, lr=0.1, alpha=0.2)(
            init_ea_state(model, tree, 0, nc), xs, ys)
        out["cycle_losses"] = losses.tolist()
        lm = transformer_lm(vocab=64, dim=64, depth=2, heads=4, max_len=16)
        lm_params = lm.init(torch.Generator().manual_seed(1), device="cpu")[0]
        tokens = np.random.RandomState(0).randint(0, 64, (2 * n, 16))
        _, lm_loss = build_lm_step(lm, tree, lr=0.1)(
            lm_params, tokens[2 * rank:2 * rank + 2].astype(np.int32))
        out["lm_loss"] = float(lm_loss)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """Run the port's data-parallel steps on ``n_devices`` gloo ranks on
    the CPU; print one line with their losses and what waits, and return
    them as a dict (``"waiting"``: part -> ROADMAP item)."""
    import torch.multiprocessing as mp

    from distlearn_tpu_torch.parallel.mesh import local_init_method
    results = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_dryrun_rank,
                       args=(n_devices, local_init_method(), results),
                       nprocs=n_devices, start_method="spawn")
    out = {**results.get(), "waiting": dict(WAITING)}
    fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)
    print(f"dryrun_multichip({n_devices}): sgd loss {out['sgd_loss']:.4f}, "
          f"ea loss {out['ea_loss']:.4f}, sgd scan losses "
          f"[{fmt(out['scan_losses'])}], ea cycle losses "
          f"[{fmt(out['cycle_losses'])}], lm loss {out['lm_loss']:.4f} "
          f"(dp={n_devices}); waiting: "
          + "; ".join(f"{k} ({v})" for k, v in WAITING.items()), flush=True)
    return out
