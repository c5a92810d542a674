"""Plain reference of the Li-Stephens leave-one-out copy model.

pbwtLikelihood.c's ``copyLogLikelihoodDropOne``: haplotype i is copied
from the other M - 1. The copy matrix starts at 1 / (M - 1) off the
diagonal; at each site every element moves as

    left[i][j] = (left[i][j] * (1 - rho) + rho / (M - 1))
                 * (x_i == x_j ? 1 - theta : theta),   left[i][i] = 0,

each row is summed, the log of its sum added to the row's total, and the
row divided by its sum. The log likelihood is the sum of the rows' totals.

Plain torch on any device, in the dtype asked for: float64 is the
configuration's precision, float32 the control. It imports nothing of the
program.
"""

from __future__ import annotations

import torch


def log_likelihood(X: torch.Tensor, theta: float, rho: float,
                   dtype: torch.dtype = torch.float64) -> float:
    """The copy model's log likelihood of the (M, N) 0/1 haplotypes X."""
    M, N = X.shape
    dev = X.device
    left = torch.full((M, M), 1.0 / (M - 1.0), dtype=dtype, device=dev)
    left.fill_diagonal_(0.0)
    total = torch.zeros(M, dtype=dtype, device=dev)
    keep, jump, same = 1.0 - rho, rho / (M - 1.0), 1.0 - theta
    for k in range(N):
        x = X[:, k]
        emit = torch.where(x[:, None] == x[None, :],
                           torch.tensor(same, dtype=dtype, device=dev),
                           torch.tensor(theta, dtype=dtype, device=dev))
        left = (left * keep + jump) * emit
        left.fill_diagonal_(0.0)
        rows = left.sum(1)
        total += torch.log(rows)
        left /= rows[:, None]
    return float(total.double().sum())
