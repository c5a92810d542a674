"""Li-Stephens leave-one-out copy-model likelihood: kernel K4 and its twin.

Counterpart of ``pbwt_tpu/ops/likelihood_jax.py``. The state of an
evaluation is the (M, M) f32 copy matrix ``left``, carried un-normalised,
the (M,) f32 reciprocal row sums ``invrs`` of the previous site, and the
(M,) per-row log-sum accumulator ``ll``. One call of :func:`ls_step` is one
site: the previous normalisation, the copy update, the zeroed diagonal, the
row sums and the log, all in place (``csrc/ls_step.cu``).

Precision: ``left`` and the row sums are f32, as on the TPU. ``ll`` is f64:
it takes M adds a site, costs nothing, and keeps the total's drift from
growing with N (the JAX scan carried it in f32; the host is f64 throughout).
So the result is f32-close to the host's, not equal to it, which is why the
route runs only when ``PBWT_TORCH_DEVICE`` asks for it
(:func:`pbwt_tpu_torch.ops.device_requested` with ``exact=False``).

Rows and columns are exactly M: the TPU's padding, column mask and row
liveness have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, resolve_device


def _constants(M: int, theta: float, rho: float):
    """(rho1, rho_m, theta, theta1) as the f32 values both versions use."""
    return tuple(float(np.float32(v)) for v in
                 (1.0 - rho, rho / (M - 1.0), theta, 1.0 - theta))


def _check(x, left, invrs, ll, M: int) -> None:
    if M < 2:
        raise ValueError(f"ls_step: the copy model needs M >= 2, got {M}")
    if (x.shape != (M,) or left.shape != (M, M) or invrs.shape != (M,)
            or ll.shape != (M,)):
        raise ValueError(f"ls_step: shapes {tuple(x.shape)}, "
                         f"{tuple(left.shape)}, {tuple(invrs.shape)}, "
                         f"{tuple(ll.shape)} do not fit M = {M}")


def ls_step_plain(x, left, invrs, ll, M: int, theta: float, rho: float):
    """Plain twin of :func:`ls_step`, in torch ops on the whole matrix."""
    _check(x, left, invrs, ll, M)
    rho1, rho_m, th, th1 = _constants(M, theta, rho)
    fac = torch.where(x[:, None] == x[None, :], th1, th).to(torch.float32)
    left.mul_((invrs * rho1)[:, None]).add_(rho_m).mul_(fac)
    left.fill_diagonal_(0.0)
    rs = left.sum(1).clamp_min(1e-30)
    ll.add_(torch.log(rs.double()))
    invrs.copy_(torch.reciprocal(rs))


def ls_step(x, left, invrs, ll, M: int, theta: float, rho: float):
    """One site of the copy model, in place (kernel K4).

    x: (M,) uint8 site column in natural order; left: (M, M) f32
    un-normalised copy matrix; invrs: (M,) f32 reciprocal row sums of the
    previous site (ones before the first); ll: (M,) f64 log row sums. CPU
    tensors run the plain twin; CUDA tensors launch the kernel.
    """
    if left.device.type == "cpu":
        return ls_step_plain(x, left, invrs, ll, M, theta, rho)
    dev = kernels.typed_cuda_tensors((x, torch.uint8), (left, torch.float32),
                                     (invrs, torch.float32),
                                     (ll, torch.float64))
    _check(x, left, invrs, ll, M)
    kernels.launch("k4_ls_step", dev.index, x.data_ptr(), left.data_ptr(),
                   invrs.data_ptr(), ll.data_ptr(), M,
                   *_constants(M, theta, rho), kernels.stream(dev))


def initial_state(M: int, device):
    """(left, invrs, ll) before the first site (likelihood_jax.py:95-97,
    111): left = 1/(M-1) off the diagonal, invrs = 1, ll = 0."""
    left = torch.full((M, M), 1.0 / (M - 1.0), dtype=torch.float32,
                      device=device)
    left.fill_diagonal_(0.0)
    return (left, torch.ones(M, dtype=torch.float32, device=device),
            torch.zeros(M, dtype=torch.float64, device=device))


def copy_ll_device(X: np.ndarray, theta: float, rho: float,
                   device=None) -> float:
    """Li-Stephens drop-one log likelihood of the (M, N) haplotypes X on
    ``device``; f32-close to the host's copy_log_likelihood_drop_one (the
    contract of ``pbwt_tpu.ops.likelihood_jax.copy_ll_device``)."""
    dev = resolve_device(device)
    M, N = X.shape
    cols = torch.from_numpy(np.ascontiguousarray(X.T, np.uint8)).to(dev)
    state = initial_state(M, dev)
    for k in range(N):
        ls_step(cols[k], *state, M, theta, rho)
    return float(state[2].sum())
