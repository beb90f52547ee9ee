"""Device-memory usage tracking (the port of amgx_tpu/memory_info.py,
the reference's MemoryInfo).

The numbers come from PyTorch's CUDA caching allocator on the solver's
device: `torch.cuda.memory_allocated` (current bytes) and
`torch.cuda.max_memory_allocated` (the allocator's own high-water mark,
which captures transient maxima -- Galerkin temporaries freed before a
phase boundary). Reading them is host bookkeeping: no device
synchronization. A CPU device reports none and reads as zero, as the
solve table's memory column does.
"""
from __future__ import annotations

import torch

# process-wide high-water marks per device, folded from every sample
_peak_per_dev: dict = {}


def _cuda_devices(devices=None):
    if devices is None:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            out.append(torch.device("cuda", d.index if d.index is not None
                                    else torch.cuda.current_device()))
    return out


def sum_device_stats(devices=None) -> dict:
    """Sum the allocator's numeric statistics (`torch.cuda.memory_stats`)
    over `devices` (all visible cards by default); empty on the CPU."""
    total: dict = {}
    for d in _cuda_devices(devices):
        for k, v in torch.cuda.memory_stats(d).items():
            if isinstance(v, (int, float)):
                total[k] = total.get(k, 0) + v
    return total


def _sample(devices):
    """(current, peak) bytes summed over `devices`, each current sample
    folded into the per-device peaks."""
    cur_sum = peak_sum = 0
    for d in _cuda_devices(devices):
        cur = int(torch.cuda.memory_allocated(d))
        key = str(d)
        _peak_per_dev[key] = max(_peak_per_dev.get(key, 0), cur)
        cur_sum += cur
        peak_sum += _peak_per_dev[key]
    return cur_sum, peak_sum


def update_max_memory_usage(devices=None) -> int:
    """Sample the current bytes (all visible cards by default), fold
    them into the high-water marks, and return them
    (updateMaxMemoryUsage analog)."""
    return _sample(devices)[0]


def usage_over(devices):
    """(current, peak) bytes over the given devices."""
    return _sample(devices)


def get_max_memory_usage() -> int:
    """High-water mark in bytes (sum of the per-device peaks)."""
    return sum(_peak_per_dev.values())


def peak_bytes(devices=None) -> int:
    """The allocator's high-water mark over `devices`
    (`torch.cuda.max_memory_allocated`, since the process started or the
    last `torch.cuda.reset_peak_memory_stats`), folded into the
    per-device peaks; 0 on the CPU."""
    total = 0
    for d in _cuda_devices(devices):
        peak = int(torch.cuda.max_memory_allocated(d))
        key = str(d)
        _peak_per_dev[key] = max(_peak_per_dev.get(key, 0), peak)
        total += peak
    return total


def get_memory_usage_gb(devices=None) -> float:
    return _sample(devices)[0] / 2**30


def reset():
    _peak_per_dev.clear()
