"""K5 (``k5_impute_vote``): one vote of T targets at Nref reference sites
(chip_smoke.py:1822-1828). It reads a donor's allele, a byte, for each
covering (segment, site) pair, a segment and a reference site whose frame
coordinate lies strictly inside it, and writes 10 B a (target, site): the
f64 dosage, the allele and the voted flag. A pair takes 4 f64 operations:
the weight's two differences and its product, and the allele-weighted
add."""

from __future__ import annotations

import torch

from . import PEAKS, bound_s


def covering_pairs(kold: torch.Tensor, seg_s: torch.Tensor,
                   seg_e: torch.Tensor) -> torch.Tensor:
    """The covering (segment, site) pairs of segments [s, e) in frame
    coordinates over the reference sites' sorted frame coordinates kold,
    as a 0-d tensor on their device (no wait for it)."""
    ko = kold.long()
    return (torch.searchsorted(ko, seg_e.long())
            - torch.searchsorted(ko, seg_s.long(), right=True)
            ).clamp(min=0).sum()


def work(pairs: int, T: int, Nref: int) -> tuple[int, int]:
    """(bytes, operations) of one vote with ``pairs`` covering pairs."""
    return pairs + 10 * T * Nref, 4 * pairs


def bound(pairs: int, T: int, Nref: int) -> float:
    return bound_s(*work(pairs, T, Nref), PEAKS["f64_ops_per_s"])
