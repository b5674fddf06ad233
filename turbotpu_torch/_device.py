"""Device resolution for the entry points: the card unless the caller asks
for the CPU.  No entry point probes for a GPU and carries on without one."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA device is "
            "available; pass device=\"cpu\" to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# The current CUDA stream of a device as a raw handle (an int), without
# building a torch.cuda.Stream object.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def raw_stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch_on(index: int, entry, *args) -> int:
    """Call a kernel's packed C entry (`_build.PackedEntry`) with `args` and
    the current stream of CUDA device `index`, entering that device's
    context only when it is not the current one.  Returns the entry's int."""
    if index == torch.cuda.current_device():
        return entry(*args, raw_stream(index))
    with torch.cuda.device(index):
        return entry(*args, raw_stream(index))
