"""K3 (``k3_match_scan``): one query scan of a batch over the standing
tables (chip_smoke.py:1544-1550). It touches, in 32-byte sectors: two ranks
a query a site, but no more than the whole rank plane (each input once); the
zero counts and the queries' words once; 6 sectors a record (a reset reads
the divergence at f', a haplotype id, a run of the query's and the
haplotype's words and a run of D[k], and writes the record); (e, f, g) in
and out. About 12 integer operations a query a site (two ranks and a
select).

The plane's size follows the matcher's layout (``ops/match.py``): rows
padded to a multiple of 2,048, sites to whole groups of 32, a block of 4
int32 words for every 96 rows and one more."""

from __future__ import annotations

from . import PEAKS, bound_s

ROW_MULTIPLE = 2048
GROUP = 32
PLANE_WORDS = 4


def plane_bytes(M: int, N: int) -> int:
    Mp = -(-M // ROW_MULTIPLE) * ROW_MULTIPLE
    ns = -(-N // GROUP) * GROUP
    return 4 * ns * PLANE_WORDS * (Mp // (GROUP * (PLANE_WORDS - 1)) + 1)


def work(M: int, N: int, Q: int, records: int) -> tuple[int, int]:
    """(bytes, operations) of one scan of Q queries over an M x N panel that
    appends ``records`` records."""
    sector = PEAKS["sector_bytes"]
    ng = -(-N // GROUP)
    ns = ng * GROUP
    plane = min(2 * sector * Q * ns, plane_bytes(M, N))
    return (plane + 4 * ns + 4 * Q * ng + 6 * sector * records + 24 * Q,
            12 * Q * ns)


def bound(M: int, N: int, Q: int, records: int) -> float:
    return bound_s(*work(M, N, Q, records))
