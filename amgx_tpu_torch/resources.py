"""Per-process platform context (the port of amgx_tpu/resources.py, the
reference's Resources).

What the JAX package keeps here is placement: which device objects
created through the context land on, and where memory statistics come
from. The port selects among the CUDA cards PyTorch sees
(`torch.cuda.device_count()`), or the CPU when the caller asks for it;
streams and memory pools belong to PyTorch. The JAX package's device
mesh comes with the distributed layer (ROADMAP.md Queue A item 13).
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import Config
from .errors import BadParametersError


class Resources:
    """Device context: config + device selection."""

    def __init__(self, cfg: Optional[Config] = None, device_num: int = 0,
                 devices=None, platform: str = "cuda"):
        self.cfg = cfg
        if platform == "cpu":
            self.devices = [torch.device("cpu")]
            self._primary = 0
            return
        if platform != "cuda":
            raise BadParametersError(
                f"Resources: platform {platform!r} (choose cuda or cpu)")
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if devices:                      # explicit device-ordinal list
            bad = [int(d) for d in devices if not 0 <= int(d) < count]
            if bad:
                raise BadParametersError(
                    f"Resources: device ordinals {list(devices)} out of "
                    f"range ({count} visible)")
            self.devices = [torch.device("cuda", int(d)) for d in devices]
            self._primary = 0
        else:
            # own every visible card; device_num selects the primary one
            # for single-device objects (resources_create semantics)
            if not 0 <= device_num < count:
                raise BadParametersError(
                    f"Resources: device_num {device_num} out of range "
                    f"({count} visible)")
            self.devices = [torch.device("cuda", i) for i in range(count)]
            self._primary = device_num

    @property
    def device(self) -> torch.device:
        """Primary device for single-device objects (pass it as
        `create_solver(..., device=res.device)`)."""
        return self.devices[self._primary]

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def device_context(self):
        """Context manager making the primary card PyTorch's current
        device (a no-op context on the CPU)."""
        import contextlib
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def memory_stats(self) -> dict:
        """The allocator's statistics summed over this context's cards
        (empty on the CPU)."""
        from .memory_info import sum_device_stats
        return sum_device_stats(self.devices)

    def update_memory_usage(self):
        """(current, peak) bytes over this context's cards
        (MemoryInfo::updateMaxMemoryUsage analog)."""
        from .memory_info import usage_over
        return usage_over(self.devices)
