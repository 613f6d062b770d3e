"""Device resolution: the port runs on the card unless told otherwise,
and a device-policy pin the card refuses stops a run before its first
read."""

from __future__ import annotations

from typing import Optional, Union

import torch

from galah_tpu_torch import config
from galah_tpu_torch.config import PLATFORMS

DeviceLike = Union[str, torch.device, None]

#: the device-policy pins the card refuses, each flag's refused values:
#: they would put a plain version or the host on a card run
CUDA_REFUSED_PINS = {
    "GALAH_TPU_PAIRLIST_STRATEGY": ("xla", "cpu"),
    "GALAH_TPU_FRAGMENT_STRATEGY": ("xla", "c"),
    "GALAH_TPU_SKETCH_STRATEGY": ("c",),
}


def pinned(flag: str, raw: Optional[str], device_type: str) -> str:
    """The route pin `flag`'s value `raw` (its ``config.env_value``),
    lowercased ('' when unset). On `device_type` ``cuda`` a value of
    ``CUDA_REFUSED_PINS`` raises ValueError naming the flag and it."""
    value = (raw or "").lower()
    if device_type == "cuda" and value in CUDA_REFUSED_PINS.get(flag, ()):
        raise ValueError(
            f"{flag}={value} is refused on cuda: the card runs only its "
            "hand-written kernels; unset it, pin a card route, or run on "
            "the CPU")
    return value


def check_pins(device_type: str) -> None:
    """``pinned`` of every flag of ``CUDA_REFUSED_PINS``: a run on the
    card stops here, before any read, on a pin the card refuses."""
    for flag in CUDA_REFUSED_PINS:
        pinned(flag, config.env_value(flag), device_type)


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``None`` and ``"cuda"`` mean the card. Asking for CUDA on a machine
    without one raises instead of quietly running on the CPU; the CPU
    runs only when the caller names it. On the card a pin it refuses
    (``check_pins``) raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    check_pins(dev.type)
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
