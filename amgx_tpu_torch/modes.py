"""Precision modes (the port of amgx_tpu/modes.py, the reference's
TemplateConfig mode system, include/amgx_config.h:102-131).

A mode is a small value object carrying torch dtypes; every kernel and
solver is dtype-polymorphic, so one implementation serves every mode.

Mode string grammar (4 letters, as the reference's, plus the
low-precision extensions):
  [0] memory space : 'd' (device) | 'h' (host) -- informational, kept
      for API parity: "hDDI" does not mean the CPU (the resources'
      `platform` chooses the device).
  [1] vector precision : D=float64 F=float32 C=complex64 Z=complex128
      B=bfloat16 H=float16
  [2] matrix precision : same alphabet
  [3] index type : I=int32 (L=int64 accepted)

dDBI keeps float64 iteration vectors over a bfloat16 matrix, the
mixed-precision play the reference's dDFI mode makes with float32.
"""
from __future__ import annotations

import dataclasses

import torch

from .errors import RC, AMGXError

_PREC = {
    "D": torch.float64,
    "F": torch.float32,
    "C": torch.complex64,
    "Z": torch.complex128,
    "B": torch.bfloat16,
    "H": torch.float16,
}
_IND = {"I": torch.int32, "L": torch.int64}


@dataclasses.dataclass(frozen=True)
class Mode:
    """Value analog of TemplateConfig<MemSpace, VecPrec, MatPrec, IndPrec>."""

    name: str
    mem_space: str          # 'd' or 'h' (informational)
    vec_dtype: torch.dtype
    mat_dtype: torch.dtype
    ind_dtype: torch.dtype

    @property
    def is_complex(self) -> bool:
        return self.vec_dtype.is_complex

    @property
    def real_dtype(self) -> torch.dtype:
        """The real dtype matching vec precision (for norms/tolerances)."""
        return torch.empty(0, dtype=self.vec_dtype).real.dtype


def parse_mode(name: str) -> Mode:
    """Parse a 4-letter mode string like 'dDDI' (AMGX_mode_dDDI)."""
    ok = (isinstance(name, str) and len(name) == 4 and name[0] in "dh"
          and name[3] in _IND and name[1] in _PREC and name[2] in _PREC)
    if not ok:
        raise AMGXError(f"invalid mode string {name!r}", RC.BAD_MODE)
    return Mode(name=name, mem_space=name[0], vec_dtype=_PREC[name[1]],
                mat_dtype=_PREC[name[2]], ind_dtype=_IND[name[3]])


# the ten "real builds" the reference instantiates (AMGX_FORALL_BUILDS,
# include/amgx_config.h) plus complex builds
ALL_MODES = tuple(
    parse_mode(m)
    for m in (
        "dDDI", "dDFI", "dFFI", "hDDI", "hDFI", "hFFI",
        "dCCI", "dZZI", "hCCI", "hZZI",
    )
)
