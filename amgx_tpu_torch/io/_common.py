"""Helpers shared by the readers and writers: dtypes, host copies and
the refusal of what the port's CsrMatrix cannot hold."""
from __future__ import annotations

import numpy as np
import torch

from ..errors import BadParametersError

_FROM_NUMPY = {"float64": torch.float64, "float32": torch.float32,
               "float16": torch.float16, "bfloat16": torch.bfloat16,
               "complex64": torch.complex64, "complex128": torch.complex128}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (numpy's bfloat16
    included, by name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _FROM_NUMPY:
        raise BadParametersError(f"unsupported value dtype {name!r}")
    return _FROM_NUMPY[name]


def host(v) -> np.ndarray:
    """A numpy copy of a tensor or array on the host; bfloat16 becomes
    float32 holding the same values (numpy has no bfloat16 of its own)."""
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def cast(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """The float64 or complex numpy array `a` as a `dtype` tensor on
    `device` (one host-to-device copy)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                         dtype=dtype)


def refuse_block(what: str):
    raise BadParametersError(
        f"{what}: block and external-diagonal matrices are not ported to "
        "amgx_tpu_torch yet (ROADMAP.md Queue A item 8.4)")
