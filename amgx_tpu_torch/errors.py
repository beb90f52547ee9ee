"""Error codes and exceptions (from amgx_tpu/errors.py, copied so the
port imports nothing of the JAX package): AMGX_RC return codes, their
strings (AMGX_get_error_string) and the exception types raised by the
config, the factories, the readers and the C API."""
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


_RC_STRINGS = {
    RC.OK: "No error.",
    RC.BAD_PARAMETERS: "Incorrect parameters for amgx call.",
    RC.UNKNOWN: "Unknown error.",
    RC.NOT_SUPPORTED_TARGET: "Unsupported target.",
    RC.NOT_SUPPORTED_BLOCKSIZE: "Unsupported block size.",
    RC.CUDA_FAILURE: "Device failure.",
    RC.IO_ERROR: "I/O error.",
    RC.BAD_MODE: "Incorrect mode.",
    RC.CORE: "Error initializing amgx core.",
    RC.PLUGIN: "Error initializing plugin.",
    RC.BAD_CONFIGURATION: "Incorrect configuration provided.",
    RC.NOT_IMPLEMENTED: "Requested feature is not implemented.",
    RC.LICENSE_NOT_FOUND: "License not found.",
    RC.INTERNAL: "Internal error.",
}


def get_error_string(rc: RC) -> str:
    return _RC_STRINGS.get(RC(rc), "Unknown error code.")


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


class IOError_(AMGXError):
    def __init__(self, message: str):
        super().__init__(message, RC.IO_ERROR)


class NotImplementedError_(AMGXError):
    def __init__(self, message: str):
        super().__init__(message, RC.NOT_IMPLEMENTED)


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


def fatal_error(message: str, rc: RC = RC.INTERNAL):
    """FatalError analog (include/error.h): raise an AMGXError."""
    raise AMGXError(message, rc)
