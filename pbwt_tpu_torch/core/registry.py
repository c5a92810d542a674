"""Process-global registries for variations, samples and populations.

The reference keeps three process-global DICTs (pbwtCore.c:28 variationDict,
pbwtSample.c:18-20 sampleDict/populationDict/samples) whose integer ids are
insertion-ordered (dict.c:125-131 ``dictAdd`` hands out 0-based ids in
insertion order).  Several algorithms compare ``varD`` ids numerically
(e.g. pbwtCore.c:644-648 selectSitesLocal), so id assignment order is
semantically load-bearing and we reproduce it exactly with insertion-ordered
Python dicts.
"""

from __future__ import annotations

from dataclasses import dataclass


class InsertionDict:
    """String-interning table: name -> 0-based insertion-order id.

    Mirrors the reference DICT (dict.h:32-46): ``add`` returns the id,
    creating it if absent; ``name(i)`` maps back.
    """

    __slots__ = ("_ids", "_names")

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}
        self._names: list[str] = []

    def add(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._names)
            self._ids[s] = i
            self._names.append(s)
        return i

    def find(self, s: str) -> int | None:
        return self._ids.get(s)

    def name(self, i: int) -> str:
        return self._names[i]

    def __len__(self) -> int:
        return len(self._names)


@dataclass
class SampleInfo:
    """Mirrors Sample (pbwt.h:65-72)."""

    nameD: int = 0
    father: int = 0
    mother: int = 0
    popD: int = 0
    isMale: bool = False
    isFemale: bool = False


# --- module-level globals, reset by init() ---------------------------------

variation_dict = InsertionDict()
sample_dict = InsertionDict()
population_dict = InsertionDict()
samples: list[SampleInfo] = [SampleInfo()]  # index 0 reserved (pbwtSample.c:29)

is_check = False
is_stats = False
n_checkpoint = 0

command_line = ""  # recorded for VCF headers (pbwtMain.c:149-161)


def init() -> None:
    """Reset all global state (the reference does this once at startup,
    pbwtCore.c:34-39 pbwtInit; we also use it between tests)."""
    global variation_dict, sample_dict, population_dict, samples
    global is_check, is_stats, n_checkpoint, command_line
    variation_dict = InsertionDict()
    sample_dict = InsertionDict()
    population_dict = InsertionDict()
    samples = [SampleInfo()]
    is_check = False
    is_stats = False
    n_checkpoint = 0
    command_line = ""


def sample_add(name: str, father: str | None = None, mother: str | None = None,
               pop: str | None = None) -> int:
    """Mirrors sampleAdd (pbwtSample.c:39-45): returns the dict id; creates
    a Sample record the first time a name is seen.  Ids start at 0 but index
    0 of ``samples`` is a reserved dummy, matching the reference where
    dictAdd ids are used directly as indexes into the samples array with a
    dummy at 0."""
    before = len(sample_dict)
    k = sample_dict.add(name)
    if len(sample_dict) != before:  # newly added
        while len(samples) <= k:
            samples.append(SampleInfo())
        samples[k] = SampleInfo(nameD=k)
    return k


def sample_name(k: int) -> str:
    return sample_dict.name(samples[k].nameD)


def pop_name(k: int) -> str:
    return population_dict.name(samples[k].popD)


def variation(ref: str, alt: str) -> int:
    """Mirrors variation() (pbwtHtslib.c:37-50): intern "REF\\tALT"."""
    return variation_dict.add(f"{ref}\t{alt}")


def variation_name(varD: int) -> str:
    """dictName with the C printf NULL rendering for unregistered ids
    (sites imported without variations, e.g. MaCS)."""
    return variation_dict.name(varD) if varD < len(variation_dict) else "(null)"
