"""K4 (``k4_ls_eval``): one copy-model evaluation (chip_smoke.py:790-793).
It reads the packed site columns (rows of 16-byte multiples) and writes the
rows' sums of logs; an element of the copy matrix takes 7 f64 operations a
site (a quotient is a product and two FMAs with the row's reciprocal made
once, two multiplies, an add, the row sum's add)."""

from __future__ import annotations

from . import PEAKS, bound_s

ELEMENT_OPS = 7


def work(M: int, N: int) -> tuple[int, int]:
    row_words = -(-M // 128) * 4
    return N * 4 * row_words + 8 * M, ELEMENT_OPS * N * M * M


def bound(M: int, N: int) -> float:
    return bound_s(*work(M, N), PEAKS["f64_ops_per_s"])
