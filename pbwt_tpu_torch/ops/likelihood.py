"""Li-Stephens leave-one-out copy-model likelihood: kernel K4 and its twins.

Counterpart of ``pbwt_tpu/ops/likelihood_jax.py``. An evaluation walks the
N sites of the panel over the (M, M) f32 copy matrix ``left``, carried
un-normalised, with the (M,) f32 reciprocal row sums ``invrs`` of the
previous site and the (M,) per-row log-sum accumulator ``ll``. Two kernels
(``csrc/ls_step.cu``) compute it, from the same (N, M) uint8 site columns:

* :func:`ls_eval` (``k4_ls_eval``): the whole evaluation in one launch. A
  block keeps its rows of ``left`` in shared memory across all sites, so the
  matrix never exists in device memory; only the site columns move.
* :func:`ls_step` (``k4_ls_step``): one site over the matrix in device
  memory, in place; an evaluation is N launches.

:func:`copy_ll_columns` chooses between them by shape alone: the one-launch
kernel whenever a row fits in shared memory (:func:`eval_config`), else the
site-by-site one. Both are hand-written kernels; on a CUDA tensor neither
gives way to a plain version.

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

SMEM_OPTIN = 232_448    # dynamic shared memory a block may opt in to (sm_90)
SM_COUNT = 132          # H100 SXM
EVAL_MAX_WARPS = 32     # warps of a k4_ls_eval block
COL_ALIGN = 16          # site columns start on 16 bytes (cp.async)


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
    """One site of the copy model, in place (kernel K4, ``k4_ls_step``).

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


def _check_cols(cols: torch.Tensor) -> tuple[int, int]:
    if cols.dim() != 2 or cols.dtype != torch.uint8:
        raise ValueError("ls_eval: the site columns must be an (N, M) uint8 "
                         f"tensor, got {cols.dtype} {tuple(cols.shape)}")
    N, M = cols.shape
    if M < 2:
        raise ValueError(f"ls_eval: the copy model needs M >= 2, got {M}")
    return N, M


def ls_steps(cols: torch.Tensor, theta: float, rho: float) -> torch.Tensor:
    """An evaluation site by site: :func:`ls_step` over the rows of
    ``cols`` from :func:`initial_state`. Returns ll (M,) f64."""
    N, M = _check_cols(cols)
    state = initial_state(M, cols.device)
    for k in range(N):
        ls_step(cols[k].contiguous(), *state, M, theta, rho)
    return state[2]


def ls_eval_plain(cols: torch.Tensor, theta: float, rho: float
                  ) -> torch.Tensor:
    """Plain twin of :func:`ls_eval`: the loop of :func:`ls_step_plain` over
    the sites."""
    N, M = _check_cols(cols)
    state = initial_state(M, cols.device)
    for k in range(N):
        ls_step_plain(cols[k], *state, M, theta, rho)
    return state[2]


def eval_config(M: int, sms: int = SM_COUNT, smem: int = SMEM_OPTIN):
    """Launch shape of ``k4_ls_eval`` for M haplotypes: (R, H), R rows of
    ``left`` resident in each block's shared memory and H warps along each
    row; None when not even one row fits beside the two column buffers.

    R starts from the most rows the shared memory holds and is then cut to
    the fewest that keep the number of waves over the card's SMs, so the
    last wave is as full as the others.
    """
    mrow = -(-M // 4) * 4                 # floats of a resident row
    mcol = -(-M // COL_ALIGN) * COL_ALIGN   # bytes of a column buffer
    fixed = 2 * mcol + 2 * 4 * EVAL_MAX_WARPS     # columns, partial sums
    r_max = min((smem - fixed) // (4 * mrow), EVAL_MAX_WARPS)
    if r_max < 1:
        return None
    waves = -(-(-(-M // r_max)) // sms)
    R = -(-M // (waves * sms))
    H = max(1, min(24 // R, 16, -(-(M // 4) // 32)))
    return R, H


def _config_on(M: int, dev: torch.device):
    """:func:`eval_config` for the card ``dev``; for the CPU, where the twin
    runs whatever the shape, that of the H100."""
    if dev.type != "cuda":
        return eval_config(M)
    props = torch.cuda.get_device_properties(dev)
    return eval_config(M, props.multi_processor_count,
                       getattr(props, "shared_memory_per_block_optin",
                               SMEM_OPTIN))


def aligned_columns(cols: torch.Tensor) -> torch.Tensor:
    """``cols`` as an (N, M) view whose rows start on COL_ALIGN bytes, which
    ``k4_ls_eval``'s asynchronous column copies need; ``cols`` itself when
    it already is one, else a padded copy."""
    N, M = cols.shape
    if (cols.stride(1) == 1 and cols.stride(0) % COL_ALIGN == 0
            and cols.stride(0) >= M and cols.data_ptr() % COL_ALIGN == 0):
        return cols
    Mp = -(-M // COL_ALIGN) * COL_ALIGN
    out = torch.zeros((N, Mp), dtype=torch.uint8, device=cols.device)
    out[:, :M] = cols
    return out[:, :M]


def ls_eval(cols: torch.Tensor, theta: float, rho: float) -> torch.Tensor:
    """A whole evaluation of the copy model in one launch (kernel K4,
    ``k4_ls_eval``): what N calls of :func:`ls_step` compute from
    :func:`initial_state`.

    cols: (N, M) uint8 site columns in natural order. Returns ll (M,) f64,
    the per-row sums of the log row sums. CPU tensors run the plain twin;
    CUDA tensors launch the kernel, and raise when a row does not fit in
    shared memory (:func:`eval_config`).
    """
    N, M = _check_cols(cols)
    if cols.device.type == "cpu":
        return ls_eval_plain(cols, theta, rho)
    if cols.device.type != "cuda":
        raise ValueError(f"pbwt_tpu_torch: no kernel for device "
                         f"{cols.device}")
    dev = cols.device
    cfg = _config_on(M, dev)
    if cfg is None:
        raise ValueError(f"ls_eval: a row of M = {M} does not fit in shared "
                         "memory; use ls_steps")
    cols = aligned_columns(cols)
    ll = torch.empty(M, dtype=torch.float64, device=dev)
    init = float(np.float32(1.0 / (M - 1.0)))
    kernels.launch("k4_ls_eval", dev.index, cols.data_ptr(), cols.stride(0),
                   N, M, *cfg, init, *_constants(M, theta, rho),
                   ll.data_ptr(), kernels.stream(dev))
    return ll


def upload_columns(X: np.ndarray, device=None) -> torch.Tensor:
    """The (M, N) haplotypes X as (N, M) uint8 site columns on ``device``,
    rows aligned for :func:`ls_eval`."""
    dev = resolve_device(device)
    M, N = X.shape
    Mp = -(-M // COL_ALIGN) * COL_ALIGN
    host = np.zeros((N, Mp), np.uint8)
    host[:, :M] = X.T
    return torch.from_numpy(host).to(dev)[:, :M]


def copy_ll_columns(cols: torch.Tensor, theta: float, rho: float) -> float:
    """Drop-one log likelihood from resident site columns: one launch of
    ``k4_ls_eval`` when a row fits in shared memory, else site by site on
    ``k4_ls_step`` (M above about 38,000). On the CPU both are the same
    plain loop."""
    _, M = _check_cols(cols)
    resident = _config_on(M, cols.device) is not None
    ll = (ls_eval if resident else ls_steps)(cols, theta, rho)
    return float(ll.sum())


def copy_ll_device(X: np.ndarray, theta: float, rho: float,
                   device=None) -> float:
    """Li-Stephens drop-one log likelihood of the (M, N) haplotypes X on
    ``device``; f32-close to the host's copy_log_likelihood_drop_one (the
    contract of ``pbwt_tpu.ops.likelihood_jax.copy_ll_device``)."""
    return copy_ll_columns(upload_columns(X, device), theta, rho)
