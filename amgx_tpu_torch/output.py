"""Print-callback indirection (the port of amgx_tpu/output.py).

All of the package's output for the library user (solve and grid
statistics) goes through `amgx_output`, so a host application can
capture it with `register_print_callback` (AMGX_register_print_callback;
one process plays rank 0).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

_callback: Optional[Callable[[str, int], None]] = None


def register_print_callback(cb: Optional[Callable[[str, int], None]]):
    """Send every message to cb(msg, len(msg)); None restores stdout."""
    global _callback
    _callback = cb


def amgx_output(msg: str):
    if _callback is not None:
        _callback(msg, len(msg))
    else:
        sys.stdout.write(msg)
        sys.stdout.flush()


def amgx_printf(*args, **kwargs):
    """print()-style convenience routed through the callback."""
    end = kwargs.pop("end", "\n")
    sep = kwargs.pop("sep", " ")
    amgx_output(sep.join(str(a) for a in args) + end)
