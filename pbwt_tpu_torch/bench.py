"""Benchmark of the port on one CUDA card: construction, the divergence
chain and standing-panel matchDynamic.

Counterpart of the root ``bench.py`` (``:112-212``, ``:278-399``), with its
output contract: the primary JSON line

  {"metric": "pbwt_build_hap_sites_per_s_per_chip", "value": N,
   "unit": "hap-sites/s", "vs_baseline": N, ...}

printed and flushed the moment the construction is measured, then one
extended line that repeats it and adds the divergence chain
(``build_ad_hap_sites_per_s``), the matcher's queries/s at each batch size,
its trajectory seconds and peak device memory, the card, the toolchain and
the kernels' launch counts.

    python -m pbwt_tpu_torch.bench [M_build] [N_build] [M_match] [Q_match]

Every timed figure is the median of REPS runs after one warm-up, each run
timed on the host clock between two ``torch.cuda.synchronize()``, with the
slowest and fastest beside it: ``<figure>_min`` and ``<figure>_max`` (for a
rate, the rates of the slowest and of the fastest run). A stage that would
not fit the deadline (``PBWT_BENCH_DEADLINE`` seconds from the start,
default 480) is skipped and listed in ``skipped``. Without a CUDA card the
bench says so on stderr and exits non-zero before printing anything: it
never times the kernels' plain twins, whatever ``PBWT_TORCH_DEVICE`` says.
A stage that fails ends the run with its exception.

:func:`entry` is the counterpart of ``__graft_entry__.entry``: the flagship
construction step (one K1 launch) with its example inputs.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import build, kernels, match, resolve_device
from .ops.partition import GROUP, ad_trajectory

# hap-sites/s/chip: the target of BASELINE.md's row "PBWT construction
# throughput" (>= 10M haplotype-sites/s/chip)
BASELINE = 1.0e7
REPS = 5                        # timed runs of a figure, after one warm-up
TILE = 1 << 14                  # haplotypes of the construction panel's tile
AD_GROUPS = 64                  # groups of sites of the divergence chain
MATCH_QS = (256, 1024, 4096)    # batch sizes of the matcher
STAGE_BUDGET_S = {"build_ad": 60, "match": 200}
LATER_Q_BUDGET_S = 60           # a batch size after the first needs this much


def build_words(M: int, N: int, Mp: int) -> np.ndarray:
    """(ceil(N/32), Mp) int32 group words of the construction panel, those
    of the root ``bench.build_words``: beta(0.2, 0.8) site frequencies, a
    TILE-wide random block of haplotypes drawn as (N, TILE) columns and
    tiled across M, the rows beyond M all-ones. The columns are drawn a
    block of sites at a time (the same stream), so no (N, TILE) float
    matrix is formed."""
    rng = np.random.RandomState(0)
    freqs = rng.beta(0.2, 0.8, size=N).astype(np.float32)
    tile = min(M, TILE)
    cols = np.empty((N, tile), np.uint8)
    B = max(1, (1 << 24) // max(tile, 1))
    for s0 in range(0, N, B):
        s1 = min(s0 + B, N)
        cols[s0:s1] = (rng.random_sample((s1 - s0, tile)).astype(np.float32)
                       < freqs[s0:s1, None])
    W_tile = build.pack_column_words(cols, tile)
    W = np.full((W_tile.shape[0], Mp), -1, np.int32)
    for t0 in range(0, M, tile):
        t1 = min(t0 + tile, M)
        W[:, t0:t1] = W_tile[:, :t1 - t0]
    return W


def bench_match_data(M: int, N: int, Qmax: int, seed: int = 0):
    """Panel (M, N) and Qmax mosaic queries of the matchDynamic benchmark,
    at seed 0 those of the root ``bench.bench_match_data`` byte for byte:
    beta(0.2, 0.8) site frequencies, the panel drawn a block of rows at a
    time, each query a mosaic of panel rows in segments of 50-399 sites.
    The queries are drawn one after another, so the first Q of a larger
    Qmax are those of Qmax = Q."""
    rng = np.random.RandomState(seed)
    freqs = rng.beta(0.2, 0.8, size=N)
    Xp = np.empty((M, N), np.uint8)
    B = max(1, (1 << 24) // max(N, 1))
    for r0 in range(0, M, B):
        r1 = min(r0 + B, M)
        Xp[r0:r1] = rng.random_sample((r1 - r0, N)) < freqs[None, :]
    Xq = np.empty((Qmax, N), np.uint8)
    for q in range(Qmax):
        pos = 0
        while pos < N:
            seg = rng.randint(50, 400)
            src = rng.randint(0, M)
            Xq[q, pos:pos + seg] = Xp[src, pos:pos + seg]
            pos += seg
    return Xp, Xq


def card_device(prog: str) -> torch.device:
    """The first CUDA card; without one, exit with a message on stderr."""
    if not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA card (torch.cuda.is_available() is "
                 "False); it times the kernels on a card, never their plain "
                 "twins on the CPU")
    return torch.device("cuda", 0)


def card_record(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi's name, power.limit) and
    the toolchain, as every line of the benches carries them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
            "card": smi[0], "torch": torch.__version__,
            "cuda": torch.version.cuda}


def timed(fn, reps: int = REPS) -> list[float]:
    """Seconds of reps runs of fn() after one warm-up, each between two
    torch.cuda.synchronize(); fn's result is dropped at once."""
    fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def rate(key: str, work: float, secs: list[float]) -> dict:
    """work / seconds as the median, and the rates of the slowest and the
    fastest run."""
    return {key: work / statistics.median(secs), f"{key}_min": work / max(secs),
            f"{key}_max": work / min(secs)}


def seconds(key: str, secs: list[float]) -> dict:
    return {key: statistics.median(secs), f"{key}_min": min(secs),
            f"{key}_max": max(secs)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bench_build(W: torch.Tensor, a0: torch.Tensor) -> list[float]:
    """Seconds of the construction scan (one K1 launch) with its final
    prefix array and zero counts copied to the host, the words resident on
    the card (the root bench.py:160-163)."""
    def run():
        _, counts, a_end, _ = build.build_scan_grouped(W, a0)
        return a_end.cpu(), counts.cpu()
    return timed(run)


def bench_build_ad(W: torch.Tensor, a0: torch.Tensor, M: int,
                   groups: int = AD_GROUPS) -> dict:
    """The divergence-carrying chain (one K2 launch) over the first groups
    of the words from the start arrays, as M x sites / seconds (the root
    bench.py:278-330)."""
    Wc = W[:groups]
    d0 = torch.zeros_like(a0)
    d0[0] = 1
    secs = timed(lambda: ad_trajectory(Wc, a0, d0))
    return rate("build_ad_hap_sites_per_s", M * Wc.shape[0] * GROUP, secs)


def bench_match_dynamic(dev: torch.device, M: int, N: int, Qs, remaining
                        ) -> dict:
    """Standing-panel matchDynamic (the root bench.py:361-399): the
    trajectory's seconds (``DeviceMatcher(Xp)``), the device memory it and
    its largest batch take at their peak (``torch.cuda.max_memory_allocated``
    above what was allocated before) beside ``table_bytes``, and queries/s
    of ``DeviceMatcher.match`` at each batch size; a batch size after the
    first runs only while remaining() allows."""
    Xp, Xq = bench_match_data(M, N, max(Qs))
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    m = match.DeviceMatcher(Xp, device=dev)
    m.match(Xq)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    out = {"match_M": M, "match_N": N, "match_peak_device_bytes": peak,
           "match_table_bytes": match.table_bytes(m.Mp, m.Ng)}
    del m
    out.update(seconds("match_traj_s", timed(
        lambda: match.DeviceMatcher(Xp, device=dev))))
    m = match.DeviceMatcher(Xp, device=dev)
    for i, Q in enumerate(Qs):
        if i and remaining() < LATER_Q_BUDGET_S:
            out.setdefault("match_skipped_q", []).append(Q)
            continue
        secs = timed(lambda: m.match(Xq[:Q]))
        if i == 0:
            out.update(rate("match_queries_per_s", Q, secs), match_Q=Q,
                       match_rows=len(m.match(Xq[:Q])))
        out.update(rate(f"match_q{Q}_per_s", Q, secs))
    return out


def entry(device=None):
    """(fn, example_args): the grouped construction scan (kernel K1, one
    launch) on a seeded 1,024 x 64 panel, the counterpart of
    ``__graft_entry__.entry``. The tensors are on ``device``: None means the
    card, or the CPU where ``PBWT_TORCH_DEVICE=cpu`` names it (there fn runs
    K1's plain twin). fn(W, a0) returns ``build_scan_grouped``'s (ycols,
    counts, a_end, d_end)."""
    dev = resolve_device(device)
    M, N = 1024, 64
    rng = np.random.RandomState(0)
    X = (rng.random_sample((M, N)) < 0.3).astype(np.uint8)
    Mp = build.pad_to(M, 256)
    W = torch.from_numpy(build.pack_group_words(X, Mp)).to(dev)
    a0 = torch.arange(Mp, dtype=torch.int32, device=dev)

    def fn(w_words, a_init):
        return build.build_scan_grouped(w_words, a_init)

    return fn, (W, a0)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    deadline = float(os.environ.get("PBWT_BENCH_DEADLINE", "480"))

    def remaining():
        return deadline - (time.perf_counter() - t_start)

    dev = card_device("pbwt_tpu_torch.bench")
    argv = sys.argv[1:] if argv is None else argv
    M = int(argv[0]) if len(argv) > 0 else 1 << 16
    N = int(argv[1]) if len(argv) > 1 else 1 << 14
    M_match = int(argv[2]) if len(argv) > 2 else 100_000
    Qs = (int(argv[3]),) if len(argv) > 3 else MATCH_QS
    record = card_record(dev)

    Mp = build.pad_to(M, 256)
    W = torch.from_numpy(build_words(M, N, Mp)).to(dev)
    a0 = torch.arange(Mp, dtype=torch.int32, device=dev)
    fig = rate("value", M * N, bench_build(W, a0))
    result = {"metric": "pbwt_build_hap_sites_per_s_per_chip",
              "value": fig["value"], "unit": "hap-sites/s",
              "vs_baseline": fig["value"] / BASELINE,
              "value_min": fig["value_min"], "value_max": fig["value_max"],
              "build_M": M, "build_N": N, "reps": REPS}
    emit(result)

    skipped = []
    if remaining() >= STAGE_BUDGET_S["build_ad"]:
        result.update(bench_build_ad(W, a0, M))
    else:
        skipped.append("build_ad")
    del W, a0
    torch.cuda.empty_cache()
    if remaining() >= STAGE_BUDGET_S["match"]:
        result.update(bench_match_dynamic(dev, M_match, 2048, Qs, remaining))
    else:
        skipped.append("match")
    result.update(record, launches=dict(kernels.LAUNCHES),
                  elapsed_s=time.perf_counter() - t_start)
    if skipped:
        result["skipped"] = skipped
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
