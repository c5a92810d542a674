"""Device engine of the port: CUDA kernels with plain-torch twins."""

from __future__ import annotations

import os

import torch


def device_requested(exact: bool = True) -> bool:
    """Should algorithms route through the device engine?

    ``PBWT_TORCH_DEVICE=0`` (or empty) keeps the host engine; any other
    value forces the device route, which on a machine without CUDA runs the
    kernels' plain-torch twins on the CPU (how the CPU tests drive it).
    Unset, the device route is on iff CUDA is available.

    Paths whose device output is only f32-close to the host's (the
    copy-model likelihood) pass ``exact=False``: as in
    ``pbwt_tpu.ops.device_requested``, they stay on the host unless
    ``PBWT_TORCH_DEVICE`` is set, so by default the CLI prints what the
    host prints.
    """
    v = os.environ.get("PBWT_TORCH_DEVICE")
    if v is not None:
        return v not in ("", "0")
    return exact and torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the first CUDA card when
    there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
