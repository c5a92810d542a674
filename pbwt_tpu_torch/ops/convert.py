"""State carried across from the JAX package into the port's layouts.

The system has no weights; its device state is the panel's planes and
tables. These functions take the JAX package's arrays as numpy and return
the port's layouts, so that state built by one package can be fed to the
other's functions (the tests do this to compare them stage by stage).
"""

from __future__ import annotations

import numpy as np


def flat_plane(plane: np.ndarray) -> np.ndarray:
    """(R, 128) TPU plane -> flat (Mp,) array, rows in order."""
    return np.ascontiguousarray(plane).reshape(-1)


def sitewords_to_ycols(ywords: np.ndarray) -> np.ndarray:
    """(S, R//32, 128) TPU site words -> (S, Mp//32) int32 packed columns.

    In the TPU layout element i = r*128 + l of site s is bit r % 32 of
    ywords[s, r // 32, l]; in the port's it is bit i % 32 of word i // 32.
    """
    u = np.ascontiguousarray(ywords).view(np.uint32)
    S, Rw, L = u.shape
    bits = (u[:, :, None, :] >> np.arange(32, dtype=np.uint32)[:, None]) & 1
    bits = bits.reshape(S, Rw * 32 * L).astype(np.uint8)
    packed = np.packbits(bits, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.int32)


def digit_planes_to_int(planes: np.ndarray) -> np.ndarray:
    """(..., R, 384) uint8 base-256 digit planes (digit j of (r, l) at
    [r, 128*j + l]) -> (..., R*128) int32."""
    p = np.asarray(planes).astype(np.int32)
    v = p[..., 0:128] + (p[..., 128:256] << 8) + (p[..., 256:384] << 16)
    return v.reshape(v.shape[:-2] + (-1,))


def ls_state_from_jax(left_p: np.ndarray, rowsum_p: np.ndarray, M: int):
    """A site of ``pbwt_tpu.ops.likelihood_jax``'s step (a padded (Mp, Mp)
    un-normalised left and its (Mp, 1) row sums, f32) -> the port's state
    after that site: the (M, M) left and its (M,) row sums, f64."""
    left = np.ascontiguousarray(np.asarray(left_p)[:M, :M], np.float64)
    return left, np.ascontiguousarray(np.asarray(rowsum_p)[:M, 0], np.float64)


def trajectory_from_jax(a_end, A_pre, D8, U8, C):
    """Outputs of ``pbwt_tpu.ops.match_jax.panel_trajectory`` -> the port's
    (A (Ns+1, Mp), D (Ns, Mp), U (Ns, Mp), C (Ns,)) int32 tables."""
    A = np.concatenate([np.asarray(A_pre), np.asarray(a_end)[None]])
    return (A.astype(np.int32), digit_planes_to_int(D8),
            digit_planes_to_int(U8), np.asarray(C).astype(np.int32))


def paint_segments_from_jax(segments: np.ndarray, n_recipients: int):
    """``pbwt_tpu.ops.paint_jax``'s (nseg, 4) rows (recipient haplotype,
    donor, start, end) -> the columns K6 takes: (seg_off (M+1,) int64, sj,
    ss, se int32), each recipient's rows in their given (report) order."""
    segs = np.asarray(segments, np.int64).reshape(-1, 4)
    segs = segs[np.argsort(segs[:, 0], kind="stable")]
    off = np.zeros(n_recipients + 1, np.int64)
    np.cumsum(np.bincount(segs[:, 0], minlength=n_recipients), out=off[1:])
    return (off, *(np.ascontiguousarray(segs[:, c], np.int32)
                   for c in (1, 2, 3)))
