"""What a run's process sets before it imports torch."""

import ctypes
import os

M_MMAP_THRESHOLD = -3           # mallopt's parameter (glibc's malloc.h)
MMAP_THRESHOLD = 128 * 1024     # glibc's initial threshold


def fix_mmap_threshold() -> None:
    """Fix glibc's mmap threshold at its initial 128 KiB, so that every
    buffer above it (a batch's rows on the host, its packed queries) comes
    fresh from the OS, as in a new process. Left to itself, glibc raises the
    threshold after each larger free; whether a batch's rows then come from
    the heap or from fresh pages, and with it the batch's time, follows the
    process's history, and runs of one cell split into a fast and a slow
    kind."""
    libc = ctypes.CDLL(None)
    if hasattr(libc, "mallopt"):
        libc.mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)


def prepare() -> None:
    """The process of a run: the port's device routes on the card and
    nowhere else (without a card they raise), the trajectory budget the
    port's own default, glibc's mmap threshold fixed."""
    os.environ["PBWT_TORCH_DEVICE"] = "1"
    os.environ.pop("PBWT_TORCH_TRAJ_BYTES", None)
    fix_mmap_threshold()
