"""Stable PBWT column partitions: kernels K1 and K2 and their plain twins.

Counterpart of ``pbwt_tpu/ops/partition_pallas.py``. Arrays are flat
``(Mp,)`` int32 tensors in sort order (the TPU's ``(R, 128)`` planes
flattened); any ``Mp`` is accepted. :func:`group_partition` and
:func:`partition_ad_step` are the counterparts of the JAX functions (one
group, one site); :func:`group_scan` and :func:`ad_trajectory` run a whole
construction scan and a whole trajectory, and :func:`ad_columns` the
divergence-carrying partition of packed sorted columns (:func:`ad_table`
the same, kept a row a site), each one persistent launch on the card
(``csrc/partition.cu``). Each wrapper runs its CUDA
kernel on CUDA tensors and its plain-torch twin on CPU tensors; it never
falls back from one to the other. The kernels choose their own launch
shape (rows a thread, blocks) from the row count and the card.
"""

from __future__ import annotations

import torch

from . import kernels

GROUP = 32   # sites per packed group word


def _exclusive_zero_rank(key: torch.Tensor):
    """(u, c): u[i] = zeros before position i, c = total zeros (int64)."""
    zero = (key == 0).long()
    incl = torch.cumsum(zero, 0)
    return incl - zero, incl[-1]


def _scatter(dst: torch.Tensor, *planes: torch.Tensor):
    return [torch.empty_like(p).scatter_(0, dst, p) for p in planes]


def _pack_bits(key: torch.Tensor) -> torch.Tensor:
    """0/1 (n,) -> (ceil(n/32),) int32 words, row i at bit i % 32 of word
    i // 32 (the layout of a warp ballot)."""
    n = key.numel()
    rw = (n + 31) // 32
    bits = torch.zeros(rw * 32, dtype=torch.int64, device=key.device)
    bits[:n] = key
    shifts = torch.arange(32, dtype=torch.int64, device=key.device)
    v = (bits.view(rw, 32) << shifts).sum(1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def group_partition_plain(w: torch.Tensor, a: torch.Tensor):
    """Plain twin of :func:`group_partition`."""
    w = w[a.long()]
    n = w.numel()
    idx = torch.arange(n, device=w.device)
    ycols = torch.empty((GROUP, (n + 31) // 32), dtype=torch.int32,
                        device=w.device)
    counts = torch.empty(GROUP, dtype=torch.int32, device=w.device)
    for s in range(GROUP):
        key = (w >> s) & 1
        ycols[s] = _pack_bits(key)
        u, c = _exclusive_zero_rank(key)
        counts[s] = c
        a, w = _scatter(torch.where(key == 0, u, c + idx - u), a, w)
    return a, w, ycols, counts


def _scratch(n: int, dev: torch.device) -> torch.Tensor:
    """Zeroed scratch of one launch: the header (barrier counter, error
    word) and one summary for each tile of the smallest size."""
    return torch.zeros(kernels.HEADER_INTS
                       + kernels.REC_INTS * -(-n // kernels.MIN_TILE),
                       dtype=torch.int32, device=dev)


def _raise_on_error(scratch: torch.Tensor, name: str) -> None:
    """Read the launch's error word (this waits for the kernel) and raise
    if a capped wait tripped."""
    code = int(scratch[kernels.ERROR_WORD])
    if code:
        what = {1: "the grid barrier", 2: "a tile summary's flag"}.get(
            code, f"error {code}")
        raise RuntimeError(f"pbwt_tpu_torch: {name} gave up waiting for "
                           f"{what}")


def _k1_launch(W, a0):
    """K1 over the (Ng, n) natural-order word planes W in one launch, the
    words carried in sort order and regathered where a group begins (for
    the scan a tenth faster than reading every site's bit through a).
    Returns (a_pp, w_pp, ycols, counts): the final prefix array and words
    are plane 1 of a_pp and w_pp."""
    dev = kernels.cuda_tensors(W, a0)
    Ng, n = W.shape
    if a0.numel() != n:
        raise ValueError(f"group partition: W has {n} rows, a {a0.numel()}")
    rw = (n + 31) // 32
    a_pp = torch.empty((2, n), dtype=torch.int32, device=dev)
    w_pp = torch.empty_like(a_pp)
    ycols = torch.empty((Ng * GROUP, rw), dtype=torch.int32, device=dev)
    counts = torch.empty(Ng * GROUP, dtype=torch.int32, device=dev)
    if n == 0 or Ng == 0:
        a_pp[1] = a0
        return a_pp, w_pp, ycols, counts
    scratch = _scratch(n, dev)
    kernels.launch("k1_group_partition", dev.index, W.data_ptr(),
                   W.stride(0), a0.data_ptr(), n, Ng, a_pp.data_ptr(),
                   w_pp.data_ptr(), ycols.data_ptr(), rw, counts.data_ptr(),
                   scratch.data_ptr(), 0, 0, kernels.stream(dev))
    _raise_on_error(scratch, "k1_group_partition")
    return a_pp, w_pp, ycols, counts


def group_partition(w: torch.Tensor, a: torch.Tensor):
    """32 stable partitions of one site group (kernel K1).

    w: (Mp,) int32 group words in NATURAL haplotype order, site s of the
    group at bit s; a: (Mp,) int32 prefix array entering the group. The
    words are first aligned to the sort order (w[a]).
    Returns (a', w' in the final sort order, ycols (32, ceil(Mp/32)) int32
    sorted columns packed 32 rows per word, counts (32,) int32 zeros per
    site).
    """
    if w.device.type == "cpu":
        return group_partition_plain(w, a)
    a_pp, w_pp, ycols, counts = _k1_launch(w.view(1, -1), a)
    return a_pp[1], w_pp[1], ycols, counts


def group_scan_plain(W: torch.Tensor, a0: torch.Tensor):
    """Plain twin of :func:`group_scan`: the groups one after another."""
    a = a0
    ys, cs = [], []
    for t in range(W.shape[0]):
        a, _, ycols, counts = group_partition_plain(W[t], a)
        ys.append(ycols)
        cs.append(counts)
    return torch.cat(ys), torch.cat(cs), a


def group_scan(W: torch.Tensor, a0: torch.Tensor):
    """The stable partitions of every site of every group (kernel K1, one
    launch for all groups).

    W: (Ng, Mp) int32 group words in natural order, Ng >= 1; a0: (Mp,) int32
    start prefix array. Returns (ycols (Ng*32, ceil(Mp/32)) int32 packed
    sorted columns, counts (Ng*32,) int32, a_end (Mp,) int32).
    """
    if W.device.type == "cpu":
        return group_scan_plain(W, a0)
    a_pp, _, ycols, counts = _k1_launch(W, a0)
    return ycols, counts, a_pp[1]


def _cummax(v: torch.Tensor, width: int = 1024) -> torch.Tensor:
    """Inclusive running max of a 1-D int64 tensor: a cummax along the rows
    of a (rows, width) view, then each row's carry from the rows before (a
    single long row would be one scan on the card)."""
    n = v.numel()
    rows = -(-n // width)
    m = torch.full((rows * width,), torch.iinfo(torch.long).min,
                   dtype=torch.long, device=v.device)
    m[:n] = v
    m = torch.cummax(m.view(rows, width), 1).values
    if rows > 1:
        carry = torch.cummax(m[:, -1], 0).values
        m[1:] = torch.maximum(m[1:], carry[:-1, None])
    return m.view(-1)[:n]


def _segmented_cummax(v: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of int v restarting at each True in resets
    (the reset applies to its own position). Segments are lifted apart by
    their index above the 32-bit value range, so one cummax serves."""
    seg = torch.cumsum(resets.long(), 0) << 32
    return _cummax(seg + (v.long() + (1 << 31))) - seg - (1 << 31)


def partition_ad_step_plain(a, d, w, s: int, kk: int):
    """Plain twin of :func:`partition_ad_step`."""
    n = a.numel()
    key = (w >> s) & 1
    zero = key == 0
    u, c = _exclusive_zero_rank(key)
    seed = d.long().clone()
    seed[0] = seed[0].clamp(min=kk + 1)
    prev0 = torch.zeros(n, dtype=torch.bool, device=a.device)
    prev1 = torch.zeros_like(prev0)
    prev0[1:] = zero[:-1]
    prev1[1:] = ~zero[:-1]
    pq = torch.where(zero, _segmented_cummax(seed, prev0),
                     _segmented_cummax(seed, prev1)).to(torch.int32)
    idx = torch.arange(n, device=a.device)
    a2, d2, w2 = _scatter(torch.where(zero, u, c + idx - u), a, pq, w)
    d2[0] = kk + 2
    return (a2, d2, w2, u.to(torch.int32),
            c.reshape(1).to(torch.int32))


def partition_ad_step(a, d, w, s: int, kk: int):
    """One site of the divergence-carrying partition (kernel K2).

    a, d, w: (Mp,) int32 in the current sort order (d without the d[M]
    sentinel); s: bit of the site in w; kk: global site index.
    Returns (a', d', w', u, count): the stable partition of (a, d, w) by
    bit s with d updated as pbwtCursorForwardsAD does (d'[0] = kk+2), the
    exclusive zero ranks u over the pre-site order, and the zero count as
    a (1,) tensor.
    """
    if a.device.type == "cpu":
        return partition_ad_step_plain(a, d, w, s, kk)
    dev = kernels.cuda_tensors(a, d, w)
    n = a.numel()
    if d.numel() != n or w.numel() != n:
        raise ValueError("partition_ad_step: a, d, w differ in length")
    if not 0 <= s < GROUP:
        raise ValueError(f"partition_ad_step: bit {s} is not in a word")
    a2, d2, w2, u = (torch.empty_like(a) for _ in range(4))
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return a2, d2, w2, u, cnt
    scratch = _scratch(n, dev)
    kernels.launch("k2_partition_ad_step", dev.index, a.data_ptr(),
                   d.data_ptr(), w.data_ptr(), None, 0, n, 1, int(s), int(kk),
                   a2.data_ptr(), d2.data_ptr(), u.data_ptr(), n,
                   w2.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), 0, 0,
                   kernels.stream(dev))
    _raise_on_error(scratch, "k2_partition_ad_step")
    return a2, d2, w2, u, cnt


def ad_columns_plain(ycols: torch.Tensor, a0: torch.Tensor,
                     d0: torch.Tensor, first_site: int = 0):
    """Plain twin of :func:`ad_columns`: :func:`partition_ad_step_plain`
    site after site on each unpacked column."""
    a, d = a0, d0
    bits = torch.arange(GROUP, dtype=torch.int64, device=ycols.device)
    for r in range(ycols.shape[0]):
        key = ((ycols[r].long()[:, None] >> bits) & 1).reshape(-1)
        a, d = partition_ad_step_plain(a, d, key[:a0.numel()].to(torch.int32),
                                       0, first_site + r)[:2]
    return a, d


def ad_columns(ycols: torch.Tensor, a0: torch.Tensor, d0: torch.Tensor,
               first_site: int = 0):
    """The divergence-carrying partition of sites given as their packed
    sorted columns (kernel K2, one launch for all sites).

    ycols: (Ns, ceil(Mp/32)) int32, site r's key of row i at bit i % 32 of
    word i // 32 of row r (the layout of :func:`group_scan`'s ycols); a0,
    d0: (Mp,) int32 the prefix and divergence arrays entering site 0, the
    global site first_site. Returns (a, d) after the last site: a is the
    final prefix array, d the divergence array (d[0] = first_site + Ns + 1).
    """
    if ycols.device.type == "cpu":
        return ad_columns_plain(ycols, a0, d0, first_site)
    dev = kernels.cuda_tensors(ycols, a0, d0)
    Ns, rw = ycols.shape
    n = a0.numel()
    if d0.numel() != n or rw != (n + 31) // 32:
        raise ValueError(f"ad_columns: a0 {n}, d0 {d0.numel()} rows, "
                         f"columns of {rw} words")
    if n == 0 or Ns == 0:
        return a0.clone(), d0.clone()
    a_pp, d_pp = (torch.empty((2, n), dtype=torch.int32, device=dev)
                  for _ in "ad")
    scratch = _scratch(n, dev)
    kernels.launch("k2_partition_ad_columns", dev.index, ycols.data_ptr(),
                   rw, a0.data_ptr(), d0.data_ptr(), n, Ns, int(first_site),
                   a_pp.data_ptr(), d_pp.data_ptr(), scratch.data_ptr(), 0, 0,
                   kernels.stream(dev))
    _raise_on_error(scratch, "k2_partition_ad_columns")
    last = (Ns - 1) % 2
    return a_pp[last], d_pp[last]


def ad_table_plain(ycols: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   first_site: int = 0):
    """Plain twin of :func:`ad_table`: :func:`partition_ad_step_plain` site
    after site on each unpacked column, each site's arrays kept as a row."""
    n = A.shape[1]
    bits = torch.arange(GROUP, dtype=torch.int64, device=ycols.device)
    for r in range(ycols.shape[0]):
        key = ((ycols[r].long()[:, None] >> bits) & 1).reshape(-1)
        A[r + 1], D[r + 1] = partition_ad_step_plain(
            A[r], D[r], key[:n].to(torch.int32), 0, first_site + r)[:2]
    return A, D


def ad_table(ycols: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             first_site: int = 0):
    """The divergence-carrying partition of sites given as their packed
    sorted columns, every site's arrays written as a row of two tables
    (kernel K2's entry ``k2_partition_ad_table``, one launch for all sites).

    ycols: (Ns, ceil(n/32)) int32 as :func:`ad_columns` takes them; A, D:
    (at least Ns + 1, n) int32 tables whose row 0 holds the prefix and
    divergence arrays entering site 0, the global site first_site. Row r + 1
    is written with the arrays after site r, so row r holds them before
    global site first_site + r (D without the d[n] sentinel, its row r's
    entry 0 first_site + r + 1 from r = 1). Returns (A, D)."""
    Ns, rw = ycols.shape
    n = A.shape[1]
    if (D.shape[1] != n or rw != (n + 31) // 32 or A.shape[0] <= Ns
            or D.shape[0] <= Ns):
        raise ValueError(f"ad_table: {Ns} sites of {rw} words, tables "
                         f"{tuple(A.shape)} and {tuple(D.shape)}")
    if ycols.device.type == "cpu":
        return ad_table_plain(ycols, A, D, first_site)
    dev = kernels.cuda_tensors(ycols, A, D)
    if n == 0 or Ns == 0:
        return A, D
    scratch = _scratch(n, dev)
    kernels.launch("k2_partition_ad_table", dev.index, ycols.data_ptr(), rw,
                   A.data_ptr(), D.data_ptr(), n, Ns, int(first_site),
                   scratch.data_ptr(), 0, 0, kernels.stream(dev))
    _raise_on_error(scratch, "k2_partition_ad_table")
    return A, D


def _trajectory_tables(W: torch.Tensor):
    Ng, Mp = W.shape
    Ns = Ng * GROUP
    A = torch.empty((Ns + 1, Mp), dtype=torch.int32, device=W.device)
    D = torch.empty((Ns, Mp), dtype=torch.int32, device=W.device)
    U = torch.empty((Ns, Mp), dtype=torch.int32, device=W.device)
    C = torch.empty(Ns, dtype=torch.int32, device=W.device)
    return A, D, U, C


def ad_trajectory_plain(W: torch.Tensor, a0: torch.Tensor, d0: torch.Tensor,
                        first_site: int = 0, out=None):
    """Plain twin of :func:`ad_trajectory`: site after site, the words
    regathered into the sort order where a group begins."""
    A, D, U, C = out if out is not None else _trajectory_tables(W)
    A[0] = a0
    d = d0
    for t in range(W.shape[0]):
        w = W[t][A[GROUP * t].long()]
        for s in range(GROUP):
            k = GROUP * t + s
            A[k + 1], d, w, U[k], C[k:k + 1] = partition_ad_step_plain(
                A[k], d, w, s, first_site + k)
            D[k] = d
    return A, D, U, C


def _check_tables(W: torch.Tensor, out) -> None:
    Ng, Mp = W.shape
    Ns = Ng * GROUP
    want = ((Ns + 1, Mp), (Ns, Mp), (Ns, Mp), (Ns,))
    if tuple(tuple(t.shape) for t in out) != want:
        raise ValueError(f"ad_trajectory: tables of shapes "
                         f"{[tuple(t.shape) for t in out]}, wanted {want}")


def ad_trajectory(W: torch.Tensor, a0: torch.Tensor, d0: torch.Tensor,
                  first_site: int = 0, out=None):
    """The divergence-carrying partition of every site of every group,
    written as the trajectory tables (kernel K2, one launch for all sites).

    W: (Ng, Mp) int32 group words in natural order; a0, d0: (Mp,) int32 the
    prefix and divergence arrays entering the first site; first_site: the
    global number of that site, so that a trajectory can go on from a
    carried (a, d) (site k of the call is site first_site + k: its
    divergence values and the d[0] sentinel are global). Returns (A (Ns+1,
    Mp): A[k] the prefix array before site k and A[Ns] the final one; D (Ns,
    Mp): the divergence array after site k; U (Ns, Mp): the exclusive zero
    ranks of site k over the pre-site order; C (Ns,): zeros at site k), all
    int32, Ns = Ng*32. out: tables of those shapes to fill in place of new
    ones (a0 and d0 must not be rows of them). The kernel reads and writes
    the tables' rows themselves.
    """
    if out is not None:
        _check_tables(W, out)
    if W.device.type == "cpu":
        return ad_trajectory_plain(W, a0, d0, first_site, out)
    A, D, U, C = out if out is not None else _trajectory_tables(W)
    dev = kernels.cuda_tensors(W, a0, d0, A, D, U, C)
    Ng, Mp = W.shape
    if a0.numel() != Mp or d0.numel() != Mp:
        raise ValueError(f"ad_trajectory: W has {Mp} rows, a0 {a0.numel()}, "
                         f"d0 {d0.numel()}")
    A[0] = a0
    if Mp == 0 or Ng == 0:
        return A, D, U, C
    scratch = _scratch(Mp, dev)
    # no word plane is carried (w_in0, w_pp None): every site reads its bit
    # through A[k], which here measured the same as carrying one
    kernels.launch("k2_partition_ad_step", dev.index, A.data_ptr(),
                   d0.data_ptr(), None, W.data_ptr(), W.stride(0), Mp,
                   Ng * GROUP, 0, int(first_site), A[1].data_ptr(),
                   D.data_ptr(), U.data_ptr(), Mp, None, C.data_ptr(),
                   scratch.data_ptr(), 0, 0, kernels.stream(dev))
    _raise_on_error(scratch, "k2_partition_ad_step")
    return A, D, U, C
