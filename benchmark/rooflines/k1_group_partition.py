"""K1 (``k1_group_partition``): one construction scan over groups of 32
sites (chip_smoke.py:497-500). The scan reads the group words (4 B a row a
group) and the prefix array, writes the packed sorted columns (Mp / 8 B a
site), the zero counts and the prefix array; a site's stable partition is
about 5 integer operations a row."""

from __future__ import annotations

from . import bound_s

GROUP = 32


def work(Mp: int, sites: int) -> tuple[int, int]:
    """(bytes, operations) of one scan of ``sites`` (whole groups) over Mp
    padded rows."""
    ng = -(-sites // GROUP)
    n = ng * GROUP
    return 4 * ng * Mp + 8 * Mp + n * (Mp // 8 + 4), 5 * n * Mp


def bound(Mp: int, sites: int) -> float:
    return bound_s(*work(Mp, sites))
