"""glibc rand() for bit-reproducible data corruption.

The reference's corruption/simulation utilities (pbwtCorruptSites/
pbwtCorruptSamples/pbwtCopySamples, pbwtImpute.c:1492-1619) draw from libc
``rand()`` without ever seeding, i.e. the default ``srand(1)`` stream.  To
crosscheck those pipelines byte-for-byte the host C runtime reproduces
glibc's TYPE_3 additive-feedback generator (csrc/pbwt_native.c
``crand_next``): a 31-word ring seeded by a Lehmer LCG,
x[i] = x[i-31] + x[i-28] mod 2^32, output = x[i] >> 1, the first 310
outputs discarded at seeding. Its corruption cores draw from the same
state, so there is one stream per process, like libc's.
"""

from __future__ import annotations

RAND_MAX = 2147483647


def rand() -> int:
    """One draw in [0, RAND_MAX] of the process-global stream."""
    from . import native
    return native.get_lib().crand_next()


def reset(seed: int = 1) -> None:
    """srand(seed) on the process-global stream."""
    from . import native
    native.get_lib().crand_srand(seed)
