"""The Li-Stephens copy model's fit (``-llCopyModel``'s evaluations).

Set-up draws the configuration's panel over a region of ``region_sites``
sites on the device (its population's mosaics, drawn over the region alone),
builds the PBWT the command would read and makes the
port's evaluator (``algos.likelihood.copy_ll_evaluator``: the pbwt decoded
and the site columns uploaded once), then evaluates once. The window fits
theta and rho as ``log_likelihood_copy_model`` does, from the traffic's
starting values: an evaluation, a line search over rho, one over theta with
a search over rho inside each of its steps, a last evaluation; then the fit
starts again. Each evaluation is a request, its log likelihood on the host.

The check: evaluations of the window drawn from the seed are computed again
by the plain f64 reference (``reference/copy_model.py``) on the region drawn
again; the largest gap relative to the reference's value must stay within
the limit.
"""

from __future__ import annotations

import random

import torch

from benchmark.generators.mosaic import Founders, stream_seed
from benchmark.harness import Check, free_device
from benchmark.reference.copy_model import log_likelihood


def line_search_positive(x_init: float, tol: float, fn) -> float:
    """Quadratic-fit line search maximising fn over x > 0: pbwtLikelihood.c's
    ``lineSearchPositive`` (:28-75), the client's side of a fit."""
    x0, y0 = 0.9 * x_init, fn(0.9 * x_init)
    x1, y1 = 1.1 * x_init, fn(1.1 * x_init)
    x2 = y2 = None
    while y0 < y1:
        x2 = min(3 * x1 - 2 * x0, 2.0 * x1)
        y2 = fn(x2)
        if y1 > y2:
            break
        x0, y0, x1, y1 = x1, y1, x2, y2
    while y0 > y1:
        x2, y2, x1, y1 = x1, y1, x0, y0
        x0 = max(3 * x1 - 2 * x2, 0.5 * x1)
        y0 = fn(x0)
    if x2 is None:
        return x1
    while x2 / x0 > tol:
        if (x1 - x0) > 2 * (x2 - x1):
            x = 0.5 * (x0 + x1)
        elif (x2 - x1) > 2 * (x1 - x0):
            x = 0.5 * (x1 + x2)
        else:
            a = (((y2 - y1) * (x1 - x0) - (y1 - y0) * (x2 - x1))
                 / ((x2 * x2 - x1 * x1) * (x1 - x0)
                    - (x1 * x1 - x0 * x0) * (x2 - x1)))
            b = 0.5 * (a * (x2 * x2 - x1 * x1) - (y2 - y1)) / (x2 - x1)
            x = b / a
        y = fn(x)
        if x > x1:
            if y > y1:
                x0, y0, x1, y1 = x1, y1, x, y
            else:
                x2, y2 = x, y
        else:
            if y > y1:
                x2, y2, x1, y1 = x1, y1, x, y
            else:
                x0, y0 = x, y
    return x1


class Driver:
    def __init__(self, run):
        self.run = run
        self.M = int(run.config["haplotypes"])
        self.R = int(run.traffic["region_sites"])
        self.evals: list = []          # (theta, rho, LL) of every request
        run.shapes.update(M=self.M, N=self.R)

    def region(self) -> torch.Tensor:
        cfg = dict(self.run.config, sites=self.R)
        return Founders(cfg, self.run.seed, self.run.device).panel(self.M)

    def setup(self) -> None:
        from pbwt_tpu_torch.algos.likelihood import copy_ll_evaluator
        from pbwt_tpu_torch.core.pbwt import PBWT
        dev = self.run.device
        X = self.region()
        X = X.cpu().numpy()
        free_device(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.evaluate = copy_ll_evaluator(PBWT.from_haplotypes(X))
        t = self.run.traffic
        self.evaluate(float(t["theta"]), float(t["rho"]))

    def hooks(self, spans) -> None:
        pass                           # an evaluation is the request itself

    def serve(self, client) -> None:
        t = self.run.traffic

        def ll(theta, rho):
            return client.request(lambda: self.evaluate(theta, rho),
                                  lambda v: self.evals.append((theta, rho, v)),
                                  evals=1)
        while True:
            state = {"theta": float(t["theta"]), "rho": float(t["rho"])}
            ll(state["theta"], state["rho"])

            def theta_fn(theta):
                state["theta"] = theta
                state["rho"] = line_search_positive(
                    state["rho"], float(t["inner_tolerance"]),
                    lambda r: ll(state["theta"], r))
                return ll(theta, state["rho"])
            state["rho"] = line_search_positive(
                state["rho"], float(t["tolerance"]),
                lambda r: ll(state["theta"], r))
            state["theta"] = line_search_positive(
                state["theta"], float(t["tolerance"]), theta_fn)
            ll(state["theta"], state["rho"])

    def after_window(self) -> None:
        del self.evaluate

    def sample(self) -> list:
        rng = random.Random(stream_seed(self.run.seed, "sample"))
        k = min(int(self.run.traffic["sampled_evals"]), len(self.evals))
        return [self.evals[i] for i in sorted(rng.sample(range(len(self.evals)), k))]

    def gaps(self, dtype=torch.float64) -> list:
        """Relative gaps of the sampled evaluations to the reference computed
        in ``dtype``."""
        X = self.region()
        out = []
        for theta, rho, got in self.sample():
            want = log_likelihood(X, theta, rho)
            value = got if dtype == torch.float64 else log_likelihood(X, theta, rho, dtype)
            out.append(abs(value - want) / abs(want))
        return out

    def check(self, dtype=torch.float64) -> list:
        return [Check("ll_rel_gap", max(self.gaps(dtype), default=float("inf")),
                      float(self.run.traffic["limits"]["ll_rel_gap"]))]

    def control(self) -> list:
        """The reference in float32, the precision below the configuration's,
        in the program's place."""
        return self.check(torch.float32)
