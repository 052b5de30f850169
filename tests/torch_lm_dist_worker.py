"""One rank of the two-rank gloo run in tests/test_torch_lm_train.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX: the parent runs the JAX reference on a two-device data mesh
and compares.  Each rank trains on its rows of the global batch and writes
what it computed to ``<out_dir>/rank<r>.npz``.
"""

import numpy as np
import torch
import torch.distributed as dist

from distlearn_tpu_torch.models.convert import lm_from_jax
from distlearn_tpu_torch.models.transformer import transformer_lm
from distlearn_tpu_torch.parallel.mesh import init_mesh
from distlearn_tpu_torch.train import lm as tlm
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = v.detach().float().numpy().copy()


def run(rank, world, store_path, inp, out_dir):
    torch.set_num_threads(2)     # two ranks and the parent share the cores
    tree = init_mesh(rank, world, store=dist.FileStore(store_path, world),
                     device="cpu")
    try:
        out = {}
        cfg = inp["cfg"]
        model = transformer_lm(**cfg)
        per = inp["tokens"].shape[0] // world
        toks = torch.from_numpy(inp["tokens"][rank * per:(rank + 1) * per])

        for fused in (False, True):
            step = tlm.build_lm_step(model, tree, lr=inp["lr"],
                                     fused=fused)
            params = lm_from_jax(inp["params"])
            for i in range(inp["steps"]):
                params, loss = step(params, toks)
                out[f"sgd_{fused}_loss{i}"] = loss.numpy()
            _flat(f"sgd_{fused}", params, out)

        step = tlm.build_lm_mixed_step(model, tree, lr=inp["lr"])
        st = tlm.init_lm_mixed_state(lm_from_jax(inp["params"]))
        for i in range(inp["steps"]):
            st, loss = step(st, toks)
            out[f"mixed_loss{i}"] = loss.numpy()
        _flat("mixed_master", st.master, out)
        out["mixed_invariant"] = np.array(all(
            torch.equal(p, m.to(p.dtype)) for p, m in zip(
                tree_leaves(st.params), tree_leaves(st.master))))

        for fused in (False, True):
            local, rnd = tlm.build_lm_ea_steps(
                model, tree, lr=inp["lr"], alpha=inp["alpha"],
                momentum=inp["momentum"], fused=fused)
            p0 = lm_from_jax(inp["params"])
            st = tlm.LMEAState(p0, tree_map(torch.clone, p0),
                               tree_map(torch.zeros_like, p0))
            for i in range(inp["steps"]):
                st, loss = local(st, toks)
                out[f"ea_{fused}_loss{i}"] = loss.numpy()
            st = rnd(st)
            _flat(f"ea_{fused}_params", st.params, out)
            _flat(f"ea_{fused}_center", st.center, out)
            _flat(f"ea_{fused}_vel", st.vel, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
