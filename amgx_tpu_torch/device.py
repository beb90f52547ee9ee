"""Where the port runs: the CUDA card unless the caller asks otherwise."""
from __future__ import annotations

import torch


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
