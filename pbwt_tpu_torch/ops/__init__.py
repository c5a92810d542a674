"""Device engine of the port: CUDA kernels with plain-torch twins.

``PBWT_TORCH_DEVICE`` routes the algorithms:

* unset: the device routes are on iff a CUDA card is there;
* ``0`` or empty: the host engine;
* ``1``: the device routes, on the first CUDA card; an error without one;
* ``cpu``: the device routes on CPU tensors, where every wrapper runs its
  kernel's plain-torch twin (how the CPU tests drive them).

The CPU is never taken unasked: without a card, a device route runs only
when the CPU is named, by ``PBWT_TORCH_DEVICE=cpu`` or ``device="cpu"``.

torch is imported when a route first needs it, not with this module, so a
command that stays on the host engine (``PBWT_TORCH_DEVICE=0``) does not pay
for it.
"""

from __future__ import annotations

import os


class NoDeviceError(RuntimeError):
    """A device route was asked for and no CUDA card is there."""

    def __init__(self):
        super().__init__(
            "no CUDA device is available; name the CPU to run the kernels' "
            "plain twins there (PBWT_TORCH_DEVICE=cpu, or device='cpu')")


def _setting() -> str | None:
    """PBWT_TORCH_DEVICE as None (unset), "0", "1" or "cpu"."""
    v = os.environ.get("PBWT_TORCH_DEVICE")
    if v is None or v in ("0", "1", "cpu"):
        return v
    if v == "":
        return "0"
    raise ValueError(f"PBWT_TORCH_DEVICE={v!r}: expected 0, 1 or cpu")


def device_requested() -> bool:
    """Should algorithms route through the device engine?
    ``PBWT_TORCH_DEVICE=1`` without a CUDA card raises."""
    v = _setting()
    if v in ("0", "cpu"):
        return v == "cpu"
    import torch
    if v == "1" and not torch.cuda.is_available():
        raise NoDeviceError()
    return torch.cuda.is_available()


def resolve_device(device=None):
    """``device`` as a torch.device. None means the CPU when
    ``PBWT_TORCH_DEVICE=cpu`` names it, else the first CUDA card; without a
    card that raises."""
    import torch
    if device is not None:
        return torch.device(device)
    if _setting() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoDeviceError()
    return torch.device("cuda", 0)
