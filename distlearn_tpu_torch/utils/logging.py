"""Role-colored structured logging (a copy of
``distlearn_tpu/utils/logging.py``) — colorPrint parity
(lua/colorPrint.lua: printServer red, printClient blue+node id), plus the
root-only-print pattern (examples/mnist.lua:20-23: non-root nodes silence
print/progress) and a CSV/JSONL metrics logger replacing optim.Logger +
gnuplot (examples/EASGD_tester.lua:47,161-165).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, IO

_RED = "\033[31m"
_BLUE = "\033[34m"
_GREEN = "\033[32m"
_RESET = "\033[0m"

_verbose = True


def set_verbose(on: bool):
    """colorPrint stubs to no-ops when --verbose unset
    (examples/EASGD_server.lua:52-56)."""
    global _verbose
    _verbose = on


def _tty(stream: IO) -> bool:
    return hasattr(stream, "isatty") and stream.isatty()


def _emit(color: str, tag: str, *args):
    if not _verbose:
        return
    msg = " ".join(str(a) for a in args)
    if _tty(sys.stdout):
        print(f"{color}{tag}{_RESET} {msg}")
    else:
        print(f"{tag} {msg}")


def print_server(*args):
    """Ref ``printServer`` (lua/colorPrint.lua:3-9)."""
    _emit(_RED, "[server]", *args)


def print_client(node: int, *args):
    """Ref ``printClient`` (lua/colorPrint.lua:11-17)."""
    _emit(_BLUE, f"[client {node}]", *args)


def print_tester(*args):
    _emit(_GREEN, "[tester]", *args)


def root_print(node_index: int):
    """Return a print fn that is a no-op off the root node
    (ref examples/mnist.lua:20-23 overwrite of ``print``)."""
    if node_index == 0:
        return print
    return lambda *a, **k: None


class MetricsLogger:
    """JSONL metrics log — optim.Logger replacement
    (ref examples/EASGD_tester.lua:40-47,161-165; plots become a JSONL any
    tool can render)."""

    def __init__(self, path: str | None = None, names: tuple = ()):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self.names = names

    def add(self, **metrics: Any):
        rec = {"ts": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
