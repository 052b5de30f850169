"""distlearn_tpu_torch — the PyTorch/CUDA port of :mod:`distlearn_tpu`.

Data-parallel training (AllReduceSGD, AllReduceEA) of the convnets on an
NVIDIA GPU: plain PyTorch for the model and collectives over
``torch.distributed`` (NCCL on the card, gloo on the CPU), and hand-written
CUDA kernels for the fused optimizer updates (``ops/csrc``).  The layout
mirrors the JAX package module for module, so each counterpart is found by
path.

This package imports ``torch`` and never ``jax`` or ``distlearn_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
