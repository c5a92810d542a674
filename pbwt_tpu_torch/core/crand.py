"""glibc rand() emulation for bit-reproducible data corruption.

The reference's corruption/simulation utilities (pbwtCorruptSites/
pbwtCorruptSamples/pbwtCopySamples, pbwtImpute.c:1492-1619) draw from libc
``rand()`` without ever seeding, i.e. the default ``srand(1)`` stream.  To
crosscheck those pipelines byte-for-byte we reproduce glibc's TYPE_3
additive-feedback generator: a 31-word ring seeded by a Lehmer LCG,
x[i] = x[i-31] + x[i-28] mod 2^32 (front/rear pointers separated by 3),
output = x[i] >> 1, first 310 outputs discarded at seeding.
"""

from __future__ import annotations

RAND_MAX = 2147483647


class GlibcRand:
    """Exact glibc random_r TYPE_3 stream (= unseeded rand())."""

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        seed &= 0xFFFFFFFF
        if seed == 0:
            seed = 1
        t = [0] * 31
        t[0] = seed
        word = seed
        for i in range(1, 31):
            # Schrage's method for 16807*word mod 2^31-1 without overflow
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            t[i] = word
        self._t = t
        self._f = 3          # front pointer; rear trails by the separation
        self._r = 0
        for _ in range(310):
            self.next()

    def next(self) -> int:
        """One rand() draw in [0, RAND_MAX]."""
        t = self._t
        f = self._f
        r = self._r
        v = (t[f] + t[r]) & 0xFFFFFFFF
        t[f] = v
        f += 1
        if f == 31:
            f = 0
        r += 1
        if r == 31:
            r = 0
        self._f = f
        self._r = r
        return v >> 1


_global = GlibcRand(1)


def rand() -> int:
    """The process-global stream, mirroring C's global rand() state.

    Delegates to the native library's stream when it is loaded, since the
    corruption cores (csrc/pbwt_native.c corrupt_*_core) consume from
    that same state — one stream per process, like libc."""
    from . import native
    lib = native.get_lib()
    if lib is not None:
        return lib.crand_next()
    return _global.next()


def reset(seed: int = 1) -> None:
    from . import native
    lib = native.get_lib()
    if lib is not None:
        lib.crand_srand(seed)
    _global.seed(seed)
