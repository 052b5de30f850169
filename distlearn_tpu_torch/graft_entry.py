"""The port's entry points for a quick check — counterpart of the root
``__graft_entry__.py`` of the JAX package.

``entry()``             the CIFAR-10 convnet's eval forward at batch 8 (the
                        reference's headline model, examples/cifar10.lua),
                        on the card unless ``device="cpu"``.
``dryrun_multichip(n)`` ``n`` gloo ranks on the CPU (the JAX package runs
                        ``n`` virtual CPU devices): the AllReduceSGD step
                        and the end-of-epoch sync, one EASGD local step and
                        round, the scanned SGD step and the EASGD cycle,
                        the transformer LM's step over a dp x sp x tp mesh
                        (ring attention, Megatron tp) and its zigzag
                        layout, and a routed MoE over an expert axis; it
                        prints and returns the parts of the JAX dry run
                        that wait for later ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import torch

#: The JAX dry run's parts the port does not run yet, with their ROADMAP
#: item.
WAITING = {
    "ZeRO-1 with tp and sp": "ROADMAP A11",
    "ZeRO-3 / FSDP": "ROADMAP A11",
    "pipeline-parallel LM (GPipe)": "ROADMAP A11",
}


def mesh_dims(n: int) -> tuple[int, int, int]:
    """The JAX dry run's (dp, sp, tp) for n devices: tp 2 when n is even,
    then sp 2 when what is left is even."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if (n // tp) % 2 == 0 else 1
    return n // (tp * sp), sp, tp


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
    from distlearn_tpu_torch.models.convert import lm_shard
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.parallel.ep import moe_ffn
    from distlearn_tpu_torch.parallel.mesh import Mesh, init_mesh, psum_raw
    from distlearn_tpu_torch.parallel.sequence import zigzag_indices
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
        dp, sp, tp = mesh_dims(n)
        mesh = Mesh((dp, sp, tp), device="cpu")
        L = 16 * sp
        lm = transformer_lm(vocab=64, dim=64, depth=2, heads=4, max_len=L)
        whole = lm.init(torch.Generator().manual_seed(1), device="cpu")[0]
        lm_params = lm_shard(whole, mesh, "model")
        d, s = mesh.axis("data"), mesh.axis("seq")
        rows, cols = 2, L // sp

        def block(toks):
            return torch.from_numpy(np.ascontiguousarray(toks[
                d.index * rows:(d.index + 1) * rows,
                s.index * cols:(s.index + 1) * cols]).astype(np.int32))
        tokens = np.random.RandomState(0).randint(0, 64, (2 * dp, L))
        _, lm_l = build_lm_step(lm, mesh, lr=0.1, seq_axis="seq",
                                tp_axis="model")(lm_params, block(tokens))
        out["lm_loss"] = float(lm_l)
        out["lm_mesh"] = (dp, sp, tp)
        if sp > 1:
            nat = np.random.RandomState(7).randint(0, 64, (2 * dp, L))
            _, zz_l = build_lm_step(lm, mesh, lr=0.1, seq_axis="seq",
                                    tp_axis="model", seq_layout="zigzag")(
                lm_params, block(nat[:, zigzag_indices(sp, L)]))
            out["zigzag_loss"] = float(zz_l)
        emesh = Mesh((n,), ("expert",), device="cpu")
        rnge = np.random.RandomState(3)
        experts = torch.from_numpy(rnge.randn(n, 8, 8).astype("float32")
                                   * 0.5)
        router = torch.from_numpy(rnge.randn(8, n).astype("float32"))
        ex = torch.from_numpy(rnge.randn(n, 4, 8).astype("float32"))
        y = moe_ffn(lambda w, h: torch.tanh(h @ w), experts[rank], router,
                    ex[rank], axis=emesh.axis("expert"))
        out["moe_sum"] = float(psum_raw(y.sum(), emesh.axis("expert")))
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
    dp, sp, tp = out["lm_mesh"]
    zz = f"zigzag-sp loss {out['zigzag_loss']:.4f}" \
        if "zigzag_loss" in out else "zigzag skipped (sp=1)"
    print(f"dryrun_multichip({n_devices}): sgd loss {out['sgd_loss']:.4f}, "
          f"ea loss {out['ea_loss']:.4f}, sgd scan losses "
          f"[{fmt(out['scan_losses'])}], ea cycle losses "
          f"[{fmt(out['cycle_losses'])}], lm loss {out['lm_loss']:.4f} "
          f"(dp={dp} sp={sp} tp={tp}), {zz}, moe-ep sum "
          f"{out['moe_sum']:.4f} ({n_devices} experts); waiting: "
          + "; ".join(f"{k} ({v})" for k, v in WAITING.items()), flush=True)
    return out
