"""Where the port runs: the CUDA card unless the caller asks otherwise."""
from __future__ import annotations

import threading

import torch

_LINALG_LOCK = threading.Lock()
_LINALG_LOADED = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card (`cuda`). Raises when the card is asked for
    (explicitly or by default) and PyTorch sees none: the port never
    drops to the CPU on its own -- pass device="cpu" for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "amgx_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def load_cuda_linalg(device: torch.device):
    """Make a process's first CUDA linear-algebra call, once, under a
    lock. PyTorch loads its CUDA linalg library at that first call, and
    two threads making it at once fail ("lazy wrapper should be called
    at most once"). The serving layer builds hierarchies (DENSE_LU's QR)
    on builder threads, several at once in a fleet, so a service on the
    card makes the call before it starts any."""
    global _LINALG_LOADED
    if device.type != "cuda":
        return
    with _LINALG_LOCK:
        if not _LINALG_LOADED:
            torch.linalg.qr(torch.eye(2, device=device))
            _LINALG_LOADED = True
