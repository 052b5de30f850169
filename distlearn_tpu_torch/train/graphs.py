"""Chained train steps as one CUDA graph a call — the card's counterpart of
the JAX package's ``lax.scan`` inside one jitted program.

:class:`GraphedProgram` wraps a ``program(state, *batch) -> (state,
losses)`` that runs K steps over batch tensors with a leading step axis.
On the first call for a set of batch shapes (one K, one batch size) it
warms the program up on a side stream, then captures it into a
``torch.cuda.CUDAGraph`` over static buffers: the state's tensors, the
batch, and the losses.  Every later call with those shapes copies the
batch in and replays the graph once; the host issues one graph launch for
all K steps.

* **State.** The graph reads the state from its own buffers and, as its
  last nodes, copies the new state back into them.  A call returns the
  state as those buffers: valid until the next call on the same program,
  which overwrites them in place (the counterpart of JAX's
  ``donate_argnums=(0,)``).  Passing that state back costs nothing;
  passing any other state copies its tensors in first.
* **Generators.** Every ``torch.Generator`` in the state (the dropout
  generator) is registered with the graph, so each replay draws from and
  advances it exactly as the same steps run eagerly do.  A state carrying
  another generator has that generator's state copied in; the returned
  state carries the registered one.
* **No fallback.** A capture or replay that fails raises.  On the CPU
  there is nothing to capture: the program runs as it is.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any

#: Untimed runs before a capture: cuDNN and cuBLAS pick and cache their
#: algorithms, NCCL starts its communicator, the allocator warms up.
WARMUP_RUNS = 1


class _Capture:
    """One captured program for one set of batch shapes."""

    def __init__(self, program: Callable, state: PyTree, batch, device):
        leaves, self.treedef = tree_flatten(state)
        self.is_gen = [isinstance(x, torch.Generator) for x in leaves]
        self.leaves = [x if g else x.detach().clone()
                       for x, g in zip(leaves, self.is_gen)]
        self.gens = [x for x, g in zip(leaves, self.is_gen) if g]
        self.batch = [b.to(device, copy=True) for b in batch]
        self.graph = torch.cuda.CUDAGraph()
        default = torch.cuda.default_generators[device.index]
        for g in self.gens:
            if g is not default:        # the default one registers itself
                self.graph.register_generator_state(g)
        self._warm_up(program, device)
        with torch.cuda.graph(self.graph):
            new_state, losses = program(self._state(), *self.batch)
            new_leaves = tree_flatten(new_state)[0]
            for buf, x, g in zip(self.leaves, new_leaves, self.is_gen):
                if not g:
                    buf.copy_(x)
            self.losses = losses

    def _state(self) -> PyTree:
        return tree_unflatten(self.treedef, self.leaves)

    def _warm_up(self, program: Callable, device) -> None:
        """Run the program on a side stream with the generators' states put
        back afterwards: the warm-up's draws must not shift the first
        replay's."""
        saved = [g.get_state() for g in self.gens]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                program(self._state(), *self.batch)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        for g, st in zip(self.gens, saved):
            g.set_state(st)

    def replay(self, state: PyTree, batch) -> tuple[PyTree, torch.Tensor]:
        leaves = tree_flatten(state)[0]
        if len(leaves) != len(self.leaves):
            raise ValueError("the state's structure differs from the one "
                             "this program was captured with")
        gi = 0
        for buf, x, g in zip(self.leaves, leaves, self.is_gen):
            if g:
                mine = self.gens[gi]
                gi += 1
                if x is not mine:
                    mine.set_state(x.get_state())
            elif x is not buf:
                buf.copy_(x)
        for buf, b in zip(self.batch, batch):
            buf.copy_(b, non_blocking=True)
        self.graph.replay()
        return self._state(), self.losses.clone()


class GraphedProgram:
    """``program`` captured once per set of batch shapes on a CUDA device,
    replayed once a call; run as it is on the CPU.  ``captures`` holds the
    graphs by batch shapes (one per distinct K and batch size)."""

    def __init__(self, program: Callable, device: torch.device):
        self.program = program
        self.device = torch.device(device)
        self.captures: dict[tuple, _Capture] = {}

    def __call__(self, state: PyTree, *batch) -> tuple[PyTree, torch.Tensor]:
        if self.device.type != "cuda":
            return self.program(state, *batch)
        batch = [torch.as_tensor(b) for b in batch]
        key = tuple((tuple(b.shape), b.dtype) for b in batch)
        cap = self.captures.get(key)
        if cap is None:
            cap = _Capture(self.program, state, batch, self.device)
            self.captures[key] = cap
        return cap.replay(state, batch)
