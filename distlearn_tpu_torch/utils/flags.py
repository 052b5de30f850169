"""Environment switches (counterpart of ``distlearn_tpu/utils/flags.py``)."""

from __future__ import annotations

import os

#: Spellings that turn a switch off; everything else that is set counts as on.
_FALSY = ("0", "false", "off", "")


def env_truthy(name: str) -> bool | None:
    """Tri-state truthiness of an env switch: ``None`` when unset (the
    caller applies its own default), else the 0/false/off/empty rule."""
    value = os.environ.get(name)
    if value is None:
        return None
    return value.lower() not in _FALSY
