"""Device resolution: the port runs on the card unless told otherwise."""

from __future__ import annotations

from typing import Union

import torch

from galah_tpu_torch.config import PLATFORMS

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``None`` and ``"cuda"`` mean the card. Asking for CUDA on a machine
    without one raises instead of quietly running on the CPU; the CPU
    runs only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_platform(platform: str) -> torch.device:
    """The device a ``--platform`` (or ``GALAH_TPU_PLATFORM``) name
    selects, ready to run on: ``torch.device("cpu")`` or
    ``torch.device("cuda")``, with no index, so a ``torchrun`` rank
    still runs on ``cuda:LOCAL_RANK`` (``parallel/distributed.py``).
    Raises RuntimeError with the reason when the platform cannot start
    here: a name the port does not run on (``tpu``, ``rocm``), or the
    card without one."""
    kind = PLATFORMS.get(platform)
    if kind is None:
        raise RuntimeError(
            f"galah_tpu_torch runs on {', '.join(sorted(PLATFORMS))}, "
            f"not {platform!r}")
    return resolve_device(kind)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a
    host clock read after it measures the work, not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
