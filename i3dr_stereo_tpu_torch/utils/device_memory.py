"""Device memory introspection — the cudaMem analog (torch port of
``i3dr_stereo_tpu.utils.device_memory``).

The reference links a binary-only ``libcudaMem.so`` exposing
getMemFree/Used/Total (include/stereoMatcher/cudaMem.h:14-17) so nodes
can report GPU headroom. Here the card's totals come from
``torch.cuda.mem_get_info`` (the driver's free and total bytes) and what
this process holds from ``torch.cuda.memory_stats`` (PyTorch's
allocator), with the same accessor surface. A CPU device reports zeros,
as the JAX package's CPU device does.
"""

from __future__ import annotations

import torch

from i3dr_stereo_tpu_torch._build import resolve_device


class DeviceMem:
    """getMemFree/Used/Total for a torch device (bytes)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def get_mem_total(self) -> int:
        return int(torch.cuda.mem_get_info(self.device)[1]) \
            if self._cuda() else 0

    def get_mem_used(self) -> int:
        if not self._cuda():
            return 0
        return int(torch.cuda.memory_stats(self.device).get(
            "allocated_bytes.all.current", 0))

    def get_mem_free(self) -> int:
        return int(torch.cuda.mem_get_info(self.device)[0]) \
            if self._cuda() else 0

    def summary(self) -> dict:
        return {
            "device": str(self.device),
            "total": self.get_mem_total(),
            "used": self.get_mem_used(),
            "free": self.get_mem_free(),
        }
