"""The host layers of pbwt_tpu that the port builds on.

They are numpy and the C runtime in ``native/`` with no framework in them,
so the port imports them rather than copying them. This module is the one
doorway: none of the names below imports jax. Host code that asks
``pbwt_tpu.ops.device_requested()`` imports jax unless ``PBWT_TPU_DEVICE=0``
is set, which the port's CLI does for its own process.
"""

from pbwt_tpu import utils
from pbwt_tpu.algos import likelihood as host_likelihood
from pbwt_tpu.algos import match as host_match
from pbwt_tpu.core import engine, native, pack3, registry
from pbwt_tpu.core.pbwt import PBWT
from pbwt_tpu.io import pbwtfile, textformats, vcf

__all__ = ["PBWT", "engine", "host_likelihood", "host_match", "native",
           "pack3", "pbwtfile", "registry", "textformats", "utils", "vcf"]
