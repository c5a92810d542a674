"""The port's partition wrappers (K1, K2) on the CPU, where they run their
plain-torch twins, against the JAX package's Pallas kernels (interpret mode)
and the host engine. Every comparison is exact: all values are integers."""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbwt_tpu.core import engine
from pbwt_tpu.ops import match_jax
from pbwt_tpu.ops import partition_pallas as pp
from pbwt_tpu_torch.ops import convert, kernels, partition

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _host_group(w, a):
    """32 stable partitions of (a, w) by bits 0..31 of w, as numpy."""
    cols, counts = [], []
    for s in range(32):
        k = (w >> s) & 1
        cols.append(k.astype(np.uint8))
        counts.append(int((k == 0).sum()))
        order = np.concatenate([np.nonzero(k == 0)[0], np.nonzero(k == 1)[0]])
        a, w = a[order], w[order]
    return a, w, np.array(cols), np.array(counts)


def _edge_words(M):
    return [np.zeros(M, np.int32), np.full(M, -1, np.int32),
            np.tile(np.array([0x55555555, 0], np.int32), M // 2)[:M]]


def test_group_partition_matches_pallas():
    M = 4096
    R = M // 128
    rng = np.random.RandomState(11)
    w_nat = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    a0 = rng.permutation(M).astype(np.int32)
    before = dict(kernels.LAUNCHES)
    for w in [w_nat] + _edge_words(M):
        a_t, w_t, ycols, counts = partition.group_partition(_t(w), _t(a0))
        ws = w[a0]                       # JAX takes words in sort order
        a_j, w_j, ywords, cnt_j = pp.group_partition(
            jnp.asarray(ws.reshape(R, 128)), jnp.asarray(a0.reshape(R, 128)),
            interpret=True)
        assert np.array_equal(a_t.numpy(), convert.flat_plane(a_j))
        assert np.array_equal(w_t.numpy(), convert.flat_plane(w_j))
        assert np.array_equal(ycols.numpy(),
                              convert.sitewords_to_ycols(np.asarray(ywords)))
        assert np.array_equal(counts.numpy(), np.asarray(cnt_j))
    assert kernels.LAUNCHES == before    # CPU tensors never reach a kernel


def test_partition_ad_step_matches_pallas():
    M = 4096
    R = M // 128
    rng = np.random.RandomState(5)
    w = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    a = rng.permutation(M).astype(np.int32)
    d = rng.randint(0, 9, size=M).astype(np.int32)
    at, dt, wt = _t(a), _t(d), _t(w)
    aj, dj, wj = (jnp.asarray(x.reshape(R, 128)) for x in (a, d, w))
    for k in range(4):
        got = partition.partition_ad_step(at, dt, wt, k, k + 3)
        ref = pp.partition_ad_step(aj, dj, wj, k, k + 3, interpret=True)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), convert.flat_plane(r))
        at, dt, wt = got[:3]
        aj, dj, wj = ref[:3]


@pytest.mark.parametrize("M", [255, 256, 4097])
def test_partitions_match_engine(M):
    rng = np.random.RandomState(M)
    w = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    w[: M // 3] = w[0]                    # long equal runs: deep divergence
    # K1 against the host chain
    a_t, w_t, ycols, counts = partition.group_partition(
        _t(w), torch.arange(M, dtype=torch.int32))
    a_h, w_h, cols_h, counts_h = _host_group(w, np.arange(M, dtype=np.int32))
    assert np.array_equal(a_t.numpy(), a_h)
    assert np.array_equal(w_t.numpy(), w_h)
    bits = np.unpackbits(ycols.numpy().view(np.uint8), axis=1,
                         bitorder="little")[:, :M]
    assert np.array_equal(bits, cols_h)
    assert np.array_equal(counts.numpy(), counts_h)
    # K2 against forwards_ad / calculate_u over 32 sites
    a = np.arange(M, dtype=np.int32)
    d = np.zeros(M + 1, np.int32)
    d[0] = d[M] = 1
    at, dt, wt = _t(a), _t(d[:M]), _t(w)
    ws = w.copy()
    for k in range(32):
        y = ((ws >> k) & 1).astype(np.uint8)
        u, c = engine.calculate_u(y)
        a, d = engine.forwards_ad(a, d, y, k)
        at, dt, wt, ut, cnt = partition.partition_ad_step(at, dt, wt, k, k)
        ws = np.concatenate([ws[y == 0], ws[y == 1]])
        assert np.array_equal(ut.numpy(), u[:M]), k
        assert int(cnt[0]) == c
        assert np.array_equal(at.numpy(), a)
        assert np.array_equal(dt.numpy(), d[:M])
        assert np.array_equal(wt.numpy(), ws)


def _trajectory_inputs(seed, Ng, Mp):
    rng = np.random.RandomState(seed)
    W = rng.randint(0, 2**32, size=(Ng, Mp), dtype=np.uint32).astype(np.int32)
    W[:, : Mp // 3] = W[:, :1]            # long equal runs: deep divergence
    W[-1, Mp // 2:] = -1                  # a stretch of sites with few zeros
    a0 = np.arange(Mp, dtype=np.int32)
    d0 = np.zeros(Mp, np.int32)
    d0[0] = 1
    return W, a0, d0


@pytest.mark.parametrize("Mp", [256, 2048, 4096])
def test_ad_trajectory_matches_jax(Mp):
    """The multi-site wrapper (on the CPU its twin, the loop of the plain
    site step) against the JAX package's panel_trajectory: the same tables,
    value for value, across a group boundary."""
    W, a0, d0 = _trajectory_inputs(Mp, 2, Mp)
    before = dict(kernels.LAUNCHES)
    got = partition.ad_trajectory(_t(W), _t(a0), _t(d0))
    a_end, A_pre, D8, _, U8, C = match_jax.panel_trajectory(
        jnp.asarray(W), jnp.asarray(a0), jnp.asarray(d0))
    want = convert.trajectory_from_jax(*(np.asarray(x) for x in
                                         (a_end, A_pre, D8, U8, C)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    assert kernels.LAUNCHES == before    # CPU tensors never reach a kernel


@pytest.mark.parametrize("Ng,cut", [(2, 1), (3, 1), (3, 2)])
def test_ad_trajectory_carried_halves_match_whole_and_jax(Ng, cut):
    """A trajectory made in two calls, the second from the first's carried
    (a, d) and first site (into tables handed in), is the whole one row for
    row, and the JAX package's."""
    Mp = 256
    W, a0, d0 = _trajectory_inputs(Ng + cut, Ng, Mp)
    whole = partition.ad_trajectory(_t(W), _t(a0), _t(d0))
    A1, D1, U1, C1 = partition.ad_trajectory(_t(W[:cut]), _t(a0), _t(d0))
    n2 = (Ng - cut) * 32
    out = (torch.full((n2 + 1, Mp), -7, dtype=torch.int32),
           torch.full((n2, Mp), -7, dtype=torch.int32),
           torch.full((n2, Mp), -7, dtype=torch.int32),
           torch.full((n2,), -7, dtype=torch.int32))
    got = partition.ad_trajectory(_t(W[cut:]), A1[-1].clone(), D1[-1].clone(),
                                  first_site=32 * cut, out=out)
    assert all(g is o for g, o in zip(got, out))
    A2, D2, U2, C2 = got
    halves = (torch.cat([A1, A2[1:]]), torch.cat([D1, D2]),
              torch.cat([U1, U2]), torch.cat([C1, C2]))
    a_end, A_pre, D8, _, U8, C = match_jax.panel_trajectory(
        jnp.asarray(W), jnp.asarray(a0), jnp.asarray(d0))
    want = convert.trajectory_from_jax(*(np.asarray(x) for x in
                                         (a_end, A_pre, D8, U8, C)))
    for h, w, j in zip(halves, whole, want):
        assert torch.equal(h, w)
        assert np.array_equal(h.numpy(), j)
    # the sentinel d[0] = k + 2 is global: without the first site it is not
    local = partition.ad_trajectory(_t(W[cut:]), A1[-1].clone(),
                                    D1[-1].clone())
    assert not torch.equal(local[1], D2)
    with pytest.raises(ValueError, match="tables"):
        partition.ad_trajectory(_t(W), _t(a0), _t(d0), out=out)


def test_ad_trajectory_rejects_what_the_kernel_does_not_take():
    """On a CUDA tensor the wrappers launch or raise; a tensor of another
    type or layout is refused before any launch (checked here without a
    card: the check comes first)."""
    W, a0, d0 = _trajectory_inputs(0, 1, 64)
    with pytest.raises(ValueError):
        kernels.cuda_tensors(_t(W), _t(a0), _t(d0))      # CPU tensors
    with pytest.raises(ValueError):
        kernels.cuda_tensors(_t(W).t())                   # not contiguous


_CTYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "double": ctypes.c_double}


def _c_entries():
    """name -> list of argument kinds of every function defined inside an
    extern "C" block of csrc/*.cu."""
    entries = {}
    for path in sorted(glob.glob(os.path.join(kernels.CSRC, "*.cu"))):
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        block = text[text.index('extern "C" {'):]
        for name, args in re.findall(r"^\w[\w ]*?\b(\w+)\(([^)]*)\) \{",
                                     block, re.M):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append("ptr")
                else:
                    kinds.append(arg.replace("const ", "")
                                 .rsplit(" ", 1)[0])
            entries[name] = kinds
    return entries


def test_c_prototypes_match_ctypes_signatures():
    """Every extern "C" entry of csrc/*.cu has the argument count and the
    pointer / int / long long / float / double kinds that ops/kernels.py
    binds it with: a mismatch would corrupt a call and cannot be seen
    without a card."""
    entries = _c_entries()
    bound = {**kernels._SIGNATURES, **kernels._AUX_SIGNATURES}
    assert set(entries) == set(bound)
    for name, kinds in entries.items():
        assert [_CTYPES[k] for k in kinds] == bound[name], name
    # an entry that launches another entry's kernel counts under its name
    assert set(kernels.LAUNCHES) == set(kernels._SIGNATURES) - set(
        kernels._KERNEL_OF)
    assert set(kernels._KERNEL_OF.values()) <= set(kernels.LAUNCHES)


@pytest.mark.parametrize("code,what", [(1, "grid barrier"), (2, "flag")])
def test_capped_wait_raises(code, what):
    """A launch whose kernel gave up a wait leaves a code in its scratch's
    error word, and the wrapper raises on it instead of returning tables."""
    scratch = partition._scratch(5000, torch.device("cpu"))
    assert scratch.numel() == kernels.HEADER_INTS + 10 * kernels.REC_INTS
    assert not scratch.any()
    partition._raise_on_error(scratch, "k2_partition_ad_step")    # clean
    scratch[kernels.ERROR_WORD] = code
    with pytest.raises(RuntimeError, match=what):
        partition._raise_on_error(scratch, "k2_partition_ad_step")
