"""pack3 encoding of packed sorted columns: the plain twin of
k1_encode_columns (encode_columns_plain, which encode_columns takes for a
CPU tensor) byte for byte against the host C encoder on the unpacked
columns and against the JAX package's encoder; and BlockBuild on the CPU
against build_pbwt_device and the JAX package's construction."""

import numpy as np
import pytest
import torch

from pbwt_tpu.core import native as jnative
from pbwt_tpu.ops import build as jbuild
from pbwt_tpu_torch.core import native
from pbwt_tpu_torch.ops import build

torch.set_num_threads(1)

IMPORT_M = 64_940      # the HRC panel's haplotypes: 64,940 % 32 = 12
TIER3 = 31 << 11       # 63,488: a run this long takes a byte of its own


def packed(Y, Mp):
    """(n, M) 0/1 sorted columns -> (n, Mp // 32) int32 words as K1 writes
    them: row i at bit i % 32 of word i // 32, rows M..Mp-1 ones."""
    n, M = Y.shape
    rows = np.ones((n, Mp), np.uint8)
    rows[:, :M] = Y
    return np.packbits(rows, axis=1, bitorder="little").view(np.int32)


def _random(M, seed=0, n=5):
    rng = np.random.RandomState(seed + M)
    return (rng.random_sample((n, M)) < rng.random_sample((n, 1))).astype(
        np.uint8)


def _run_lengths():
    """A site for each length: a run of it from row 0, then a run of the
    other symbol to the end; and the same run ending at the last row."""
    lengths = (63, 64, 2_047, 2_048, TIER3 - 1, TIER3)
    Y = np.zeros((2 * len(lengths), IMPORT_M), np.uint8)
    for i, L in enumerate(lengths):
        Y[2 * i, L:] = 1
        Y[2 * i + 1, :IMPORT_M - L] = 1
    return Y


def _crossing():
    """Runs of 20, 40, 33, 95, 1 and 67 rows in turn: across one word
    boundary, two, and ending on one."""
    y = np.repeat(np.arange(6) % 2, (20, 40, 33, 95, 1, 67)).astype(np.uint8)
    return np.stack((y, 1 - y))


# case -> (sorted columns (n, M), rows padded to Mp)
CASES = {
    "random_M_multiple_of_32": lambda: (_random(64), 64),
    "random_M_multiple_of_32_pad_rows": lambda: (_random(96), 256),
    "random_M_not_multiple_of_32": lambda: (_random(70), 256),
    "random_odd_word_count": lambda: (_random(70), 96),
    "random_import_width": lambda: (_random(IMPORT_M, n=3), 65_024),
    "all_zero_past_tier3": lambda: (np.zeros((2, IMPORT_M), np.uint8),
                                    65_024),
    "all_one_past_tier3": lambda: (np.ones((2, IMPORT_M), np.uint8), 65_024),
    "all_zero_two_tier3_bytes": lambda: (np.zeros((1, 2 * TIER3 + 5),
                                                  np.uint8), 2 * TIER3 + 32),
    "alternating_rows": lambda: (np.tile(np.arange(101) % 2, (3, 1))
                                 .astype(np.uint8), 256),
    "run_lengths_at_tier_edges": lambda: (_run_lengths(), 65_024),
    "runs_across_words": lambda: (_crossing(), 256),
    "one_row": lambda: (np.array([[0], [1]], np.uint8), 32),
}


@pytest.mark.parametrize("case", list(CASES) + ["block_ending_inside_group"])
def test_encode_columns_plain_matches_host_and_jax(case):
    if case == "block_ending_inside_group":
        # K1's twin over 37 sites (the last group padded with all-ones
        # sites); the block's sorted columns are its first 37 rows
        M, n = 70, 37
        cols = _random(M, 3, n)
        Mp = build.pad_to(M)
        W = build.pack_columns(torch.from_numpy(cols), Mp)
        ycols = build.build_scan_grouped(
            W, torch.arange(Mp, dtype=torch.int32))[0]
        assert ycols.shape[0] == 64
        ycols = ycols[:n].numpy()
    else:
        Y, Mp = CASES[case]()
        M = Y.shape[1]
        ycols = packed(Y, Mp)
        assert np.array_equal(build.unpack_columns(ycols, M), Y)
    Y = build.unpack_columns(ycols, M)
    got = build.encode_columns_plain(torch.from_numpy(ycols), M)
    assert got.dtype == torch.uint8
    got = got.numpy().tobytes()
    assert got == native.encode_cols(Y)[0]
    assert got == jnative.encode_cols(Y)[0]
    assert build.encode_columns(torch.from_numpy(ycols), M) == got


@pytest.mark.parametrize("M,sizes", [(70, (64, 32, 37)), (100, (32, 5)),
                                     (33, (7,))])
def test_block_build_encodes_like_jax(monkeypatch, M, sizes):
    """BlockBuild on the CPU over blocks of whole groups and a last block
    that ends inside one: each block's sorted columns go to encode_columns
    as a tensor of the block's sites, and the panel's yz and aFend are
    build_pbwt_device's and the JAX package's."""
    seen = []
    real = build.encode_columns
    monkeypatch.setattr(build, "encode_columns", lambda ycols, M: seen.append(
        (type(ycols), len(ycols))) or real(ycols, M))
    X = _random(sum(sizes), M + 1, M)
    bb = build.BlockBuild(M, device="cpu")
    s = 0
    for n in sizes:
        bb.add(np.ascontiguousarray(X[:, s:s + n].T))
        s += n
    yz, a_end = bb.finish()
    assert seen == [(torch.Tensor, n) for n in sizes]
    monkeypatch.setattr(build, "encode_columns", real)
    want_yz, want_a, _ = build.build_pbwt_device(X, device="cpu")
    yz_j, a_j, _ = jbuild.build_pbwt_device(X, multiple=8)
    assert yz == want_yz == yz_j
    assert np.array_equal(a_end, want_a) and np.array_equal(a_end, a_j)


def test_encode_columns_of_nothing():
    """No sites, or no rows: no bytes."""
    assert build.encode_columns(torch.zeros((0, 8), dtype=torch.int32),
                                70) == b""
    assert build.encode_columns(torch.zeros((3, 8), dtype=torch.int32),
                                0) == b""
