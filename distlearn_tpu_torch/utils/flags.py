"""Environment switches and declarative CLI flags (counterpart of
``distlearn_tpu/utils/flags.py``, the reference's lapp heredocs).  The
JAX package's ``--tpu`` switch becomes ``--device``, which defaults to the
card."""

from __future__ import annotations

import argparse
import os
from typing import Any, Sequence

#: Spellings that turn a switch off; everything else that is set counts as on.
_FALSY = ("0", "false", "off", "")


def env_truthy(name: str) -> bool | None:
    """Tri-state truthiness of an env switch: ``None`` when unset (the
    caller applies its own default), else the 0/false/off/empty rule."""
    value = os.environ.get(name)
    if value is None:
        return None
    return value.lower() not in _FALSY


def _flag(parser: argparse.ArgumentParser, name: str, default, help_: str):
    if isinstance(default, bool):
        parser.add_argument(f"--{name}", action="store_true", default=default,
                            help=help_)
    else:
        parser.add_argument(f"--{name}", type=type(default), default=default,
                            help=help_)


def parse_flags(description: str, spec: dict[str, tuple[Any, str]],
                argv: Sequence[str] | None = None) -> argparse.Namespace:
    """``spec``: ``{flag_name: (default, help)}``, mirroring a lapp block."""
    p = argparse.ArgumentParser(description=description)
    for name, (default, help_) in spec.items():
        _flag(p, name, default, help_)
    return p.parse_args(argv)


# Flag groups shared by the example scripts (same names as the reference).

NODE_FLAGS = {
    "nodeIndex": (1, "1-based node index (reference convention)"),
    "numNodes": (1, "number of nodes"),
}

TRAIN_FLAGS = {
    "batchSize": (32, "global batch size (per-node = ceil(B/N), cifar10.lua:36)"),
    "learningRate": (0.1, "learning rate"),
    "numEpochs": (10, "number of epochs"),
    "device": ("cuda", "torch device to run on (replaces the reference "
                       "--cuda); 'cpu' only when asked for"),
    "seed": (0, "init seed (reference: torch.manualSeed(0))"),
}

EA_FLAGS = {
    "communicationTime": (10, "tau — steps between elastic rounds"),
    "alpha": (0.2, "elastic moving rate"),
}

# The JAX package's --overlapSync, --shards and --save wait for the
# concurrent server, stripes and checkpoints (ROADMAP A9(c)/(d)).
ASYNC_FLAGS = {
    "host": ("127.0.0.1", "server host"),
    "port": (8080, "server base port"),
    "verbose": (False, "protocol logging (colorPrint parity)"),
    "testTime": (10, "server-side syncs between test pushes"),
    "wireCodec": ("raw", "sync wire codec: raw (packed fp32), fp16, int8 "
                         "(quantized deltas with error feedback), or "
                         "legacy (per-leaf frames, pre-packed peers)"),
}
