"""Li-Stephens leave-one-out copy-model likelihood: kernel K4 and its twins.

Counterpart of ``pbwt_tpu/ops/likelihood_jax.py``, computing what the host
computes in f64 (``algos/likelihood.py:_copy_ll_host``, the JAX package's
``copy_log_likelihood_drop_one``) exactly. An evaluation walks the N sites of
the panel over the state (``left``, ``rs``, ``ll``): the (M, M) f64 copy
matrix of the last site, un-normalised; its (M,) f64 row sums (ones before
the first site); and the (M,) f64 per-row sums of their logs. A site:

    left = ((left / rs) * (1-rho) + rho/(M-1)) * (x_i == x_j ? 1-theta : theta)
    left[i][i] = 0;  rs = row sums of left;  ll += log(rs)

every operation rounded on its own, as numpy rounds it. The host divides at
the end of a site; the division here opens the next one, which rounds alike.
A row sum follows numpy's order (:func:`sum_plan`, :func:`row_sums`), so the
row sums equal the host's bit for bit; only the logs may differ from
numpy's, by their own ulps. The total is numpy's ``ll.sum()`` of the
downloaded ``ll`` (:func:`copy_ll_columns`), the host's order over rows.

Two kernels (``csrc/ls_step.cu``) compute it, from the site columns packed
as bits (:class:`SiteColumns`):

* :func:`ls_eval` (``k4_ls_eval``): the whole evaluation in one launch. A
  block keeps its row of ``left`` in shared memory across all sites, so the
  matrix never exists in device memory; only the site columns move.
* :func:`ls_step` (``k4_ls_step``): one site over the matrix in device
  memory, in place; an evaluation is N launches.

``k4_ls_eval`` takes a row sum as its split of numpy's tree
(:func:`eval_plan`: two lanes a leaf, the lower nodes by shuffles inside a
warp, the upper ones in shared memory), ``k4_ls_step`` and the twins'
:func:`row_sums` as :func:`sum_plan` gives it.
:func:`copy_ll_columns` chooses between them by shape alone: the one-launch
kernel whenever a row fits in shared memory (:func:`eval_config`), else the
site-by-site one. Both are hand-written kernels; on a CUDA tensor neither
gives way to a plain version. The twins (:func:`ls_step_plain`,
:func:`ls_eval_plain`) are plain torch f64 with the same order of the row
sums, so that twin and kernel agree to the bit on one device.

Rows and columns are exactly M: the TPU's padding, column mask and row
liveness have no counterpart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import kernels, resolve_device

SMEM_OPTIN = 232_448    # dynamic shared memory a block may opt in to (sm_90)
EVAL_MAX_WARPS = 20     # warps of a k4_ls_eval block (its launch bound)
RING = 3                # site columns in flight in a k4_ls_eval block
LANES = 32              # a warp
LEAVES = 16             # leaves a warp takes: two lanes a leaf
MAX_ROUNDS = 8          # shuffle heights inside a warp the kernels unroll
COL_ALIGN = 16          # packed site columns: rows of 16 bytes (cp.async)

# numpy's order of left.sum(axis=1): a row cut into chunks, each summed by
# pairwise_sum in leaves of at most PAIRWISE_LEAF elements. numpy 2.0 cuts a
# C-contiguous row at its ufunc buffer (8,192 elements); numpy 2.3.5 passes
# the whole row (WHOLE_ROW). numpy_chunk finds which the installed numpy does
NUMPY_BUFSIZE = 8192
WHOLE_ROW = 0
NUMPY_CHUNKS = (NUMPY_BUFSIZE, WHOLE_ROW)
PAIRWISE_LEAF = 128
PLAN_HEAD = 4           # leaves, inner nodes, heights, root
# the probe of numpy_chunk: rows over three buffers and a ragged end
PROBE_M = 3 * NUMPY_BUFSIZE + 77
# the twin's row sums take rows in blocks of about this many elements
PLAIN_BLOCK_ELEMENTS = 1 << 25


@functools.cache
def numpy_chunk() -> int:
    """The chunk of NUMPY_CHUNKS in which the installed numpy sums a
    C-contiguous f64 row, found by summing two probe rows of PROBE_M values
    over many orders of magnitude both ways. Raises when neither matches:
    the row sums would then not be the host's."""
    rng = np.random.RandomState(0)
    a = rng.random_sample((2, PROBE_M)) * np.exp(
        3 * rng.standard_normal((2, PROBE_M)))
    want = a.sum(axis=1)
    for chunk in NUMPY_CHUNKS:
        if np.array_equal(row_sums(torch.from_numpy(a), chunk).numpy(), want):
            return chunk
    raise RuntimeError(f"numpy {np.__version__} sums a row in none of the "
                       f"orders the copy model knows (chunks {NUMPY_CHUNKS})")


def sum_plan(M: int, chunk: int | None = None) -> np.ndarray:
    """numpy's order of the sum of a row of M f64 values, as an int32 array:
    [L, T, heights, root], the L + 1 starts of the leaves, the heights + 1
    offsets of the inner nodes sorted by height, their T left children and
    their T right children. Node l < L is leaf l, node L + t inner node t,
    the sum of its two children.

    The row is cut into chunks of ``chunk`` elements (None: the installed
    numpy's, :func:`numpy_chunk`; WHOLE_ROW: one chunk), whose sums are
    added from the left. A chunk is numpy's pairwise_sum: a leaf when it has
    at most PAIRWISE_LEAF elements, else split at n/2 - (n/2) % 8. A leaf of
    n >= 8 elements is 8 strided accumulators combined as
    ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then its last n % 8 elements in
    order; a shorter one a sum from 0."""
    return _sum_plan(M, numpy_chunk() if chunk is None else chunk)


@functools.lru_cache(maxsize=16)
def _sum_plan(M: int, chunk: int) -> np.ndarray:
    if M < 1:
        raise ValueError(f"sum_plan: a row needs M >= 1, got {M}")
    chunk = chunk or M
    # leaves: their starts; inner: (left, right, height), each node as
    # ("leaf", index) or ("inner", index)
    leaves, inner = [], []

    def pairwise(start, n):
        if n <= PAIRWISE_LEAF:
            leaves.append(start)
            return ("leaf", len(leaves) - 1), 0
        n2 = n // 2
        n2 -= n2 % 8
        a, ha = pairwise(start, n2)
        b, hb = pairwise(start + n2, n - n2)
        inner.append((a, b, 1 + max(ha, hb)))
        return ("inner", len(inner) - 1), 1 + max(ha, hb)

    acc = None
    for c0 in range(0, M, chunk):
        node = pairwise(c0, min(chunk, M - c0))
        if acc is None:
            acc = node
        else:
            h = 1 + max(acc[1], node[1])
            inner.append((acc[0], node[0], h))
            acc = ("inner", len(inner) - 1), h
    starts = leaves + [M]
    L, T = len(leaves), len(inner)
    order = sorted(range(T), key=lambda t: inner[t][2])   # stable
    rank = {t: r for r, t in enumerate(order)}

    def index(node):
        return node[1] if node[0] == "leaf" else L + rank[node[1]]

    heights = max((h for _, _, h in inner), default=0)
    offsets = np.searchsorted([inner[t][2] for t in order],
                              np.arange(1, heights + 2)).tolist()
    left = [index(inner[t][0]) for t in order]
    right = [index(inner[t][1]) for t in order]
    plan = [L, T, heights, index(acc[0]), *starts, *offsets, *left, *right]
    out = np.asarray(plan, np.int32)
    out.setflags(write=False)
    return out


def plan_nodes(M: int) -> int:
    """Leaves and inner nodes of :func:`sum_plan` (M)."""
    plan = sum_plan(M)
    return int(plan[0] + plan[1])


def eval_plan(M: int, chunk: int | None = None) -> np.ndarray:
    """``k4_ls_eval``'s split of :func:`sum_plan` (M, ``chunk`` as there),
    as an int32 array.

    Lanes 2l and 2l + 1 of a row's warps (warp l // LEAVES) take leaf l,
    4 of its 8 accumulators each. A node whose leaves all lie in one warp
    is summed there by shuffles, one round a height: in round h - 1 the
    lanes of its leftmost leaf add the values of the lanes of its right
    child's leftmost leaf. The highest such node over each stretch of
    leaves (or a leaf that no such node covers) goes to the row's nodes in
    shared memory; the upper nodes, whose children lie in different warps,
    are summed from there a height at a time (by one warp, 64 of them from
    registers). Every node is still the sum of its two children, so the
    row sum is numpy's bit for bit (the CPU tests evaluate this split lane
    by lane against numpy's order).

    Layout: [L, L + T, rounds, U, UH, root, W, row length]; the L + 1 leaf
    starts; the W + 1 offsets of each warp's elements in a row as
    ``k4_ls_eval`` keeps it in shared memory (element 8t + 4h + u of the
    leaf of lane j = 2l + h of warp w, u < 4, is the lane's element q = 4t
    + u, at offset[w] + 2 * LANES * (q // 2) + 2j + q % 2: a lane's
    elements side by side in pairs, so that a warp reads 16 bytes a lane;
    a warp takes LANES times the most any of its lanes holds, rounded up
    to pairs); rounds x L source leaves in the warp (-1: no add in that
    round); L destination nodes (-1: none); the UH + 1 offsets of the upper
    nodes by height; their U nodes, left children and right children.
    Node indices are sum_plan's."""
    return _eval_plan(M, numpy_chunk() if chunk is None else chunk)


@functools.lru_cache(maxsize=16)
def _eval_plan(M: int, chunk: int) -> np.ndarray:
    plan = _sum_plan(M, chunk)
    L, T, heights, root = (int(v) for v in plan[:PLAN_HEAD])
    starts = plan[PLAN_HEAD:PLAN_HEAD + L + 1].astype(np.int64)
    off = plan[PLAN_HEAD + L + 1:PLAN_HEAD + L + 2 + heights]
    left = plan[PLAN_HEAD + L + 2 + heights:][:T].astype(np.int64)
    right = plan[PLAN_HEAD + L + 2 + heights + T:][:T].astype(np.int64)
    # each node's leaves [lo, hi), height and parent
    lo = np.concatenate([np.arange(L), np.zeros(T, np.int64)])
    hi = np.concatenate([np.arange(1, L + 1), np.zeros(T, np.int64)])
    height = np.zeros(L + T, np.int64)
    parent = np.full(L + T, -1, np.int64)
    for h in range(heights):
        for t in range(off[h], off[h + 1]):
            n = L + t
            lo[n], hi[n], height[n] = lo[left[t]], hi[right[t]], h + 1
            parent[left[t]] = parent[right[t]] = n
    inwarp = lo // LEAVES == (hi - 1) // LEAVES
    rounds = int(height[inwarp].max())
    if rounds > MAX_ROUNDS:
        raise ValueError(f"eval_plan: {rounds} shuffle rounds at M = {M}, "
                         f"the kernels unroll {MAX_ROUNDS}")
    code = np.full((rounds, L), -1, np.int64)
    for t in np.flatnonzero(inwarp[L:]):
        code[height[L + t] - 1, lo[L + t]] = lo[right[t]] % LEAVES
    top = np.flatnonzero(inwarp & ((parent < 0) | ~inwarp[parent]))
    dst = np.full(L, -1, np.int64)
    dst[lo[top]] = top
    upper = np.flatnonzero(~inwarp[L:])      # by height, as sum_plan's
    uheight = height[L + upper]
    uoff = [*np.searchsorted(uheight, np.unique(uheight)), len(upper)]
    W = -(-L // LEAVES)
    size = np.diff(starts)
    half = 4 * (size // 8) + np.minimum(size % 8, 4)  # the most a lane holds
    pairs = [-(-int(half[w * LEAVES:(w + 1) * LEAVES].max()) // 2)
             for w in range(W)]
    wbase = np.cumsum([0] + [2 * LANES * n for n in pairs])
    out = np.asarray([L, L + T, rounds, len(upper), len(uoff) - 1, root, W,
                      wbase[-1], *starts, *wbase, *code.ravel(), *dst, *uoff,
                      *(L + upper), *left[upper], *right[upper]], np.int32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=16)
def _plain_plan(M: int, device: torch.device, chunk: int):
    """:func:`sum_plan` (M, chunk) as the twin's gather indices on
    ``device``: the (L, 16, 8) element of each leaf's accumulators and the
    (L, 7) of its remainder, M where there is none (a zero column), and the
    inner nodes' heights as (left, right) index tensors."""
    plan = sum_plan(M, chunk)
    L, T, heights = (int(v) for v in plan[:3])
    starts = plan[PLAN_HEAD:PLAN_HEAD + L + 1]
    acc = np.full((L, PAIRWISE_LEAF // 8, 8), M, np.int64)
    rest = np.full((L, 7), M, np.int64)
    for leaf in range(L):
        s, n = int(starts[leaf]), int(starts[leaf + 1] - starts[leaf])
        n8 = n - n % 8 if n >= 8 else 0
        acc[leaf, :n8 // 8] = np.arange(s, s + n8).reshape(-1, 8)
        rest[leaf, :n - n8] = np.arange(s + n8, s + n)
    off = plan[PLAN_HEAD + L + 1:PLAN_HEAD + L + 2 + heights]
    left = plan[PLAN_HEAD + L + 2 + heights:][:T]
    right = plan[PLAN_HEAD + L + 2 + heights + T:][:T]
    levels = [tuple(torch.from_numpy(np.asarray(v[a:b], np.int64)).to(device)
                    for v in (left, right))
              for a, b in zip(off[:-1], off[1:])]
    return (torch.from_numpy(acc).to(device), torch.from_numpy(rest).to(device),
            levels, L, int(plan[3]))


def row_sums(a: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Plain twin of the kernels' row sum: (rows, M) f64 -> (rows,) f64,
    each row summed in numpy's order (:func:`sum_plan`, ``chunk`` as
    there), so equal bit for bit to ``a.numpy().sum(axis=1)``. The
    accumulators of all leaves are summed at once, with zeros after their
    last element (x + 0 is x)."""
    rows, M = a.shape
    chunk = numpy_chunk() if chunk is None else chunk
    acc_idx, rest_idx, levels, L, root = _plain_plan(M, a.device, chunk)
    padded = torch.cat([a, a.new_zeros(rows, 1)], 1)
    acc = padded[:, acc_idx]                         # (rows, L, 16, 8)
    r = acc[:, :, 0]
    for q in range(1, acc.shape[2]):
        r = r + acc[:, :, q]
    r = r[..., 0::2] + r[..., 1::2]
    r = r[..., 0::2] + r[..., 1::2]
    s = r[..., 0] + r[..., 1]
    rest = padded[:, rest_idx]
    for q in range(rest.shape[2]):
        s = s + rest[:, :, q]
    nodes = torch.empty((rows, L + sum(len(lv[0]) for lv in levels)),
                        dtype=a.dtype, device=a.device)
    nodes[:, :L] = s
    at = L
    for left, right in levels:
        nodes[:, at:at + len(left)] = nodes[:, left] + nodes[:, right]
        at += len(left)
    return nodes[:, root]


def _constants(M: int, theta: float, rho: float):
    """(rho1, rho_m, theta, theta1) as the host computes them, in f64."""
    return 1.0 - rho, rho / (M - 1.0), theta, 1.0 - theta


def _check(x, left, rs, ll, M: int) -> None:
    if M < 2:
        raise ValueError(f"ls_step: the copy model needs M >= 2, got {M}")
    if (x.shape != (M,) or left.shape != (M, M) or rs.shape != (M,)
            or ll.shape != (M,)):
        raise ValueError(f"ls_step: shapes {tuple(x.shape)}, "
                         f"{tuple(left.shape)}, {tuple(rs.shape)}, "
                         f"{tuple(ll.shape)} do not fit M = {M}")


def ls_step_plain(x, left, rs, ll, M: int, theta: float, rho: float):
    """Plain twin of :func:`ls_step`, in torch f64 on blocks of rows."""
    _check(x, left, rs, ll, M)
    rho1, rho_m, th, th1 = _constants(M, theta, rho)
    fac = torch.tensor([th, th1], dtype=torch.float64, device=left.device)
    step = max(1, PLAIN_BLOCK_ELEMENTS // M)
    for r0 in range(0, M, step):
        r1 = min(M, r0 + step)
        blk = left[r0:r1]
        blk.div_(rs[r0:r1, None]).mul_(rho1).add_(rho_m)
        blk.mul_(fac[(x[r0:r1, None] == x[None, :]).long()])
        rows = torch.arange(r1 - r0, device=left.device)
        blk[rows, rows + r0] = 0.0
        rs[r0:r1] = row_sums(blk)
    ll.add_(torch.log(rs))


def ls_step(x, left, rs, ll, M: int, theta: float, rho: float):
    """One site of the copy model, in place (kernel K4, ``k4_ls_step``).

    x: (M,) uint8 site column in natural order; left: (M, M) f64
    un-normalised copy matrix of the previous site; rs: (M,) f64 its row
    sums (ones before the first site), replaced by this site's; ll: (M,) f64
    log row sums, accumulated. CPU tensors run the plain twin; CUDA tensors
    launch the kernel.
    """
    if left.device.type == "cpu":
        return ls_step_plain(x, left, rs, ll, M, theta, rho)
    dev = kernels.typed_cuda_tensors((x, torch.uint8), (left, torch.float64),
                                     (rs, torch.float64),
                                     (ll, torch.float64))
    _check(x, left, rs, ll, M)
    kernels.launch("k4_ls_step", dev.index, x.data_ptr(), left.data_ptr(),
                   rs.data_ptr(), ll.data_ptr(), M,
                   _plan_on(sum_plan, M, dev).data_ptr(), plan_nodes(M),
                   *_constants(M, theta, rho), kernels.stream(dev))


@functools.lru_cache(maxsize=16)
def _plan_on(plan, M: int, dev: torch.device) -> torch.Tensor:
    """``plan`` (M), :func:`sum_plan` or :func:`eval_plan`, on the card,
    uploaded once."""
    return torch.from_numpy(plan(M).copy()).to(dev)


def initial_state(M: int, device):
    """(left, rs, ll) before the first site: left = 1/(M-1) off the
    diagonal, rs = 1, ll = 0. On a card, raises when the matrix does not
    fit in its free memory."""
    dev = torch.device(device)
    if dev.type == "cuda":
        need = 8 * M * M + 16 * M
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        if need > free:
            raise ValueError(f"the copy model of {M} haplotypes needs {need} "
                             f"bytes of device memory for its (M, M) f64 "
                             f"matrix and {free} are free")
    left = torch.full((M, M), 1.0 / (M - 1.0), dtype=torch.float64,
                      device=dev)
    left.fill_diagonal_(0.0)
    return (left, torch.ones(M, dtype=torch.float64, device=dev),
            torch.zeros(M, dtype=torch.float64, device=dev))


def _row_words(M: int) -> int:
    """int32 words of a packed site column of M alleles: 16-byte rows."""
    return -(-M // (8 * COL_ALIGN)) * (COL_ALIGN // 4)


class SiteColumns(NamedTuple):
    """N site columns of M 0/1 alleles packed as the kernels read them: bit
    j of word w of row k is haplotype 32w + j's allele at site k, rows of
    :func:`_row_words` (M) words (16 bytes each, for the asynchronous
    copies), the bits past M zero."""
    words: torch.Tensor     # (N, _row_words(M)) int32
    M: int

    def alleles(self) -> torch.Tensor:
        """The (N, M) uint8 columns, unpacked on the words' device."""
        b = self.words.view(torch.uint8)
        bit = torch.arange(8, dtype=torch.uint8, device=b.device)
        return ((b[..., None] >> bit) & 1).reshape(b.shape[0], -1)[:, :self.M]


def upload_columns(X: np.ndarray, device=None) -> SiteColumns:
    """The (M, N) 0/1 haplotypes X as packed site columns on ``device``."""
    dev = resolve_device(device)
    M, N = X.shape
    if X.size and X.max() > 1:
        raise ValueError("the copy model takes alleles 0 and 1")
    host = np.zeros((N, 4 * _row_words(M)), np.uint8)
    host[:, :-(-M // 8)] = np.packbits(X.T, axis=1, bitorder="little")
    return SiteColumns(torch.from_numpy(host.view(np.int32)).to(dev), M)


def _check_cols(cols: SiteColumns) -> tuple[int, int]:
    if not isinstance(cols, SiteColumns):
        raise ValueError("ls_eval: the site columns must be SiteColumns "
                         f"(upload_columns), got {type(cols)}")
    N, M = cols.words.shape[0], cols.M
    if M < 2:
        raise ValueError(f"ls_eval: the copy model needs M >= 2, got {M}")
    if (cols.words.dtype != torch.int32
            or cols.words.shape != (N, _row_words(M))):
        raise ValueError(f"ls_eval: packed columns of M = {M} are (N, "
                         f"{_row_words(M)}) int32, got {cols.words.dtype} "
                         f"{tuple(cols.words.shape)}")
    return N, M


def _check_sums(sums, N: int, M: int, dev) -> None:
    if sums is not None and (sums.shape != (N, M)
                             or sums.dtype != torch.float64
                             or sums.device != dev
                             or not sums.is_contiguous()):
        raise ValueError(f"ls_eval: sums must be a contiguous ({N}, {M}) "
                         f"float64 tensor on {dev}")


def ls_steps(cols: SiteColumns, theta: float, rho: float,
             sums: torch.Tensor | None = None) -> torch.Tensor:
    """An evaluation site by site: :func:`ls_step` over the sites of
    ``cols`` from :func:`initial_state`. Returns ll (M,) f64; ``sums``, if
    given, takes each site's row sums."""
    N, M = _check_cols(cols)
    dev = cols.words.device
    _check_sums(sums, N, M, dev)
    state = initial_state(M, dev)
    x = cols.alleles()
    for k in range(N):
        ls_step(x[k], *state, M, theta, rho)
        if sums is not None:
            sums[k] = state[1]
    return state[2]


def ls_eval_plain(cols: SiteColumns, theta: float, rho: float,
                  sums: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of :func:`ls_eval`: the loop of :func:`ls_step_plain` over
    the sites."""
    N, M = _check_cols(cols)
    dev = cols.words.device
    _check_sums(sums, N, M, dev)
    state = initial_state(M, dev)
    x = cols.alleles()
    for k in range(N):
        ls_step_plain(x[k], *state, M, theta, rho)
        if sums is not None:
            sums[k] = state[1]
    return state[2]


def eval_smem(M: int) -> int:
    """Shared memory of a ``k4_ls_eval`` block, one row: its elements in the
    layout of :func:`eval_plan`, its plan's nodes (an even count) and its
    row sum (and a pad) in f64, and a ring of RING packed site columns."""
    p = eval_plan(M)
    nodes, rowlen = int(p[1]), int(p[7])
    return 8 * (rowlen + nodes + nodes % 2 + 2) + RING * 4 * _row_words(M)


def eval_config(M: int, smem: int = SMEM_OPTIN):
    """Warps of a ``k4_ls_eval`` block for M haplotypes: one block a row, two
    lanes a leaf of :func:`eval_plan`; None when the row does not fit in a
    block's shared memory or needs more than EVAL_MAX_WARPS warps. An SM
    holds as many rows as its shared memory and registers take (5 at
    5,008). The row's layout and the plan's nodes depend on the installed
    numpy's order (:func:`numpy_chunk`), and so does which rows fit: on the
    H100 up to 26,664 haplotypes in numpy 2.3's order, and up to 27,146 in
    numpy 2.0's, except from 26,505 to 26,751."""
    W = int(eval_plan(M)[6])
    return W if W <= EVAL_MAX_WARPS and eval_smem(M) <= smem else None


def _config_on(M: int, dev: torch.device):
    """:func:`eval_config` for the card ``dev``; for the CPU, where the twin
    runs whatever the shape, that of the H100."""
    if dev.type != "cuda":
        return eval_config(M)
    props = torch.cuda.get_device_properties(dev)
    return eval_config(M, getattr(props, "shared_memory_per_block_optin",
                                  SMEM_OPTIN))


def ls_eval(cols: SiteColumns, theta: float, rho: float,
            sums: torch.Tensor | None = None) -> torch.Tensor:
    """A whole evaluation of the copy model in one launch (kernel K4,
    ``k4_ls_eval``): what N calls of :func:`ls_step` compute from
    :func:`initial_state`.

    cols: the N packed site columns. Returns ll (M,) f64, the per-row sums
    of the log row sums; ``sums``, an (N, M) f64 tensor if given, takes
    each site's row sums. CPU tensors run the plain twin; CUDA tensors
    launch the kernel, and raise when a row does not fit in shared memory
    (:func:`eval_config`).
    """
    N, M = _check_cols(cols)
    words = cols.words
    if words.device.type == "cpu":
        return ls_eval_plain(cols, theta, rho, sums)
    dev = kernels.typed_cuda_tensors((words, torch.int32))
    _check_sums(sums, N, M, dev)
    warps = _config_on(M, dev)
    if warps is None:
        raise ValueError(f"ls_eval: a row of M = {M} does not fit in shared "
                         "memory; use ls_steps")
    plan = eval_plan(M)
    ll = torch.empty(M, dtype=torch.float64, device=dev)
    kernels.launch("k4_ls_eval", dev.index, words.data_ptr(),
                   words.stride(0) * 4, N, M, warps,
                   _plan_on(eval_plan, M, dev).data_ptr(), int(plan[1]),
                   int(plan[7]),
                   1.0 / (M - 1.0), *_constants(M, theta, rho),
                   ll.data_ptr(), 0 if sums is None else sums.data_ptr(),
                   kernels.stream(dev))
    return ll


def copy_ll_columns(cols: SiteColumns, theta: float, rho: float) -> float:
    """Drop-one log likelihood from resident packed site columns: one
    launch of ``k4_ls_eval`` when a row fits in shared memory, else site by
    site on ``k4_ls_step`` (M above 26,664 in numpy 2.3's order,
    :func:`eval_config`). On
    the CPU both are the same plain loop. The per-row sums come back to the
    host and are added by numpy, in the host's order."""
    _, M = _check_cols(cols)
    resident = _config_on(M, cols.words.device) is not None
    ll = (ls_eval if resident else ls_steps)(cols, theta, rho)
    return float(ll.cpu().numpy().sum())


def copy_ll_device(X: np.ndarray, theta: float, rho: float,
                   device=None) -> float:
    """Li-Stephens drop-one log likelihood of the (M, N) haplotypes X on
    ``device``: the host's copy_log_likelihood_drop_one, its row sums bit
    for bit, its logs within their ulps."""
    return copy_ll_columns(upload_columns(X, device), theta, rho)
