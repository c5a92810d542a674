"""Likelihood models: the device route of -llCopyModel on kernel K4.

Counterpart of ``pbwt_tpu/algos/likelihood.py:234-291``. The copy model's
evaluation goes to :func:`pbwt_tpu_torch.ops.likelihood.copy_ll_device`
when ``device_requested(exact=False)``, that is only when
``PBWT_TORCH_DEVICE`` is set, and to the host's f64 numpy otherwise, so by
default stdout is the host's. The line search and ``-fitAlphaBeta`` (which
has no device route in the JAX package either) are the host's.
"""

from __future__ import annotations

import sys

from ..host import PBWT, host_likelihood
from ..ops import device_requested

fit_alpha_beta = host_likelihood.fit_alpha_beta
line_search_positive = host_likelihood.line_search_positive


def copy_log_likelihood_drop_one(p: PBWT, theta: float, rho: float) -> float:
    """Li-Stephens leave-one-out log likelihood (copyLogLikelihoodDropOne,
    pbwtLikelihood.c:380-420)."""
    if device_requested(exact=False):
        from ..ops.likelihood import copy_ll_device
        return copy_ll_device(p.haplotypes(), theta, rho)
    return host_likelihood.copy_log_likelihood_drop_one(p, theta, rho)


def log_likelihood_copy_model(p: PBWT, theta: float, rho: float) -> None:
    """pbwtLogLikelihoodCopyModel (pbwtLikelihood.c:434-445)."""
    out = sys.stdout
    LL = copy_log_likelihood_drop_one(p, theta, rho)
    out.write(f"theta {theta:f} rho {rho:f} LL {LL:f}  per site {LL / p.N:f}  "
              f"per cell {LL / (p.M * p.N):f}\n")
    state = {"theta": theta, "rho": rho}

    def rho_fn(r):
        return copy_log_likelihood_drop_one(p, state["theta"], r)

    def theta_fn(t):
        state["theta"] = t
        state["rho"] = line_search_positive(state["rho"], 1.001, rho_fn)
        return copy_log_likelihood_drop_one(p, t, state["rho"])

    state["rho"] = line_search_positive(rho, 1.01, rho_fn)
    state["theta"] = line_search_positive(theta, 1.01, theta_fn)
    LL = copy_log_likelihood_drop_one(p, state["theta"], state["rho"]) / p.N
    out.write(f"Fit theta {state['theta']:f}  rho {state['rho']:f}  "
              f"LL per site {LL:f}  per cell {LL / p.M:f}\n")
