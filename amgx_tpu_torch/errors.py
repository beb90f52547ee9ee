"""Error codes and exceptions (from amgx_tpu/errors.py, copied so the
port imports nothing of the JAX package): AMGX_RC return codes plus the
exception types raised by the config and the factories."""
from __future__ import annotations

import enum
import traceback


class RC(enum.IntEnum):
    """API return codes (parity with AMGX_RC in include/amgx_c.h)."""

    OK = 0
    BAD_PARAMETERS = 1
    UNKNOWN = 2
    NOT_SUPPORTED_TARGET = 3
    NOT_SUPPORTED_BLOCKSIZE = 4
    CUDA_FAILURE = 5          # kept for API parity; maps to device failures
    IO_ERROR = 6
    BAD_MODE = 7
    CORE = 8
    PLUGIN = 9
    BAD_CONFIGURATION = 10
    NOT_IMPLEMENTED = 11
    LICENSE_NOT_FOUND = 12
    INTERNAL = 13


class AMGXError(Exception):
    """Internal exception carrying an RC code and a `where` location
    (analog of amgx_exception, include/error.h)."""

    def __init__(self, message: str, rc: RC = RC.UNKNOWN):
        super().__init__(message)
        self.rc = RC(rc)
        # capture the raising site, like amgx_exception::where(): the
        # innermost frame outside this module (works for direct raises and
        # subclass constructors alike)
        self._where = "?"
        for fr in reversed(traceback.extract_stack()):
            if not fr.filename.endswith("errors.py"):
                self._where = f"{fr.filename}:{fr.lineno}"
                break

    def where(self) -> str:
        return self._where


class BadParametersError(AMGXError):
    def __init__(self, message: str):
        super().__init__(message, RC.BAD_PARAMETERS)


class BadConfigurationError(AMGXError):
    def __init__(self, message: str):
        super().__init__(message, RC.BAD_CONFIGURATION)


def did_you_mean(name: str, candidates) -> str:
    """A ' (did you mean ...?)' suffix for unknown-key errors, or ''
    when nothing is close. Used by the config registry and the
    component factories so a typo'd parameter or solver name fails
    with a suggestion instead of a bare rejection."""
    import difflib
    matches = difflib.get_close_matches(
        str(name), [str(c) for c in candidates], n=2, cutoff=0.6)
    if not matches:
        return ""
    return " (did you mean " + " or ".join(
        repr(m) for m in matches) + "?)"

