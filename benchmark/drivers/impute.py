"""Reference imputation against a standing panel (``-referenceImpute``'s
device route).

Set-up draws the configuration's panel on the device (the ``hrc`` recipe, so
for a seed the ``hrc`` configuration's panel at its size), builds its PBWT
through the port's block construction (``BlockBuild`` in blocks of
``io/vcf.BLOCK_BYTES``, as ``-readVcfGT`` does on a card), types one site in
``typed_every``, drawn from the seed among the sites whose panel allele
frequency lies in ``typed_frequency``, selects the frame (the panel at the
typed sites) and makes the program's ``ReferenceImputer``, which holds the
reference standing on the card. The pool: ``pool_batches`` batches of
``targets`` target haplotypes, fresh mosaics of the same founders observed
at the typed sites only, each a PBWT of those sites as a ``.pbwt`` read
would give it. The first is imputed once to warm every stage, and the frame
matcher matches each other one, so that its record cap is learned before the
window. The window sends the batches in turn, one
``impute`` call a request, each returning the imputed PBWT (alleles,
dosages, info scores) on the host.

The check: a sample of the targets of each pooled batch, drawn from the
seed, is imputed again by the plain reference (``reference/impute.py``) on
the panel drawn again; the alleles and dosage codes that the program's
results of a few requests of the window (a reservoir drawn from the seed)
hold for them, decoded from each result's pack3 and dosage streams, must be
the reference's at every reference site. The info score of every reference
site in the kept results of one batch (the first kept request's) must be
within its limit of the reference's over that whole batch: sums of f64
dosages over the targets, in another order there. The control puts the
reference computed in float32 in the program's place.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from benchmark.generators.mosaic import Founders, generator, stream_seed
from benchmark.harness import Check, free_device
from benchmark.reference import impute as reference
from benchmark.rooflines.k5_impute_vote import covering_pairs

CHROM = "20"
FIRST_POSITION, POSITION_STEP = 60_001, 76     # about 2.5 Mb for 32,768 sites


def typed_sites(ones: torch.Tensor, M: int, cfg: dict, seed: int) -> np.ndarray:
    """The sorted indices of the typed sites: sites // typed_every of them,
    drawn from the seed among the sites whose share of 1 alleles, ones / M
    (ones: (N,) counts on the device), lies in the band typed_frequency."""
    a = cfg["assumed"]
    lo, hi = a["typed_frequency"]
    freq = ones.double() / M
    cand = torch.nonzero((freq >= lo) & (freq <= hi)).flatten()
    n = int(cfg["sites"]) // int(a["typed_every"])
    if len(cand) < n:
        raise ValueError(f"{len(cand)} sites in the band {lo}-{hi}, "
                         f"{n} to type")
    gen = generator(ones.device, seed, "typed")
    pick = torch.randperm(len(cand), generator=gen, device=ones.device)[:n]
    return np.sort(cand[pick].cpu().numpy())


def decoded(p_new, targets) -> tuple[np.ndarray, np.ndarray]:
    """(alleles, dosage codes), (len(targets), N) uint8, of the targets of
    an imputed PBWT, read from its pack3 alleles and its dosage stream
    (each site's run-length codes in the site's sorted order, the prefix
    array walked forward from the identity). A dosage stream whose sites do
    not each hold M codes reads as codes of 255."""
    T, N = p_new.M, p_new.N
    Y = p_new.decoded(True)                               # (N, T) sorted
    z = np.frombuffer(p_new.zDosage, np.uint8)
    sym = z >> 5
    n = (z & 31).astype(np.int64) << np.select([sym == 6, sym == 7], [5, 10], 0)
    before = np.concatenate([[0], np.cumsum(n)])
    off = np.asarray(p_new.dosageOffset, np.int64)
    if (len(off) == N and before[-1] == N * T and (off < len(before)).all()
            and np.array_equal(before[off], np.arange(N) * T)):
        C = np.repeat(np.where(sym >= 6, 0, sym), n).reshape(N, T)
    else:
        C = np.full((N, T), 255, np.uint8)
    targets = np.asarray(targets)
    alleles = np.empty((len(targets), N), np.uint8)
    codes = np.empty((len(targets), N), np.uint8)
    a, pos, order = np.arange(T), np.empty(T, np.int64), np.arange(T)
    for k in range(N):
        pos[a] = order
        at = pos[targets]
        alleles[:, k], codes[:, k] = Y[k][at], C[k][at]
        a = np.concatenate((a[Y[k] == 0], a[Y[k] == 1]))
    return alleles, codes


class Driver:
    def __init__(self, run):
        self.run = run
        cfg, t = run.config, run.traffic
        self.M, self.N = int(cfg["haplotypes"]), int(cfg["sites"])
        self.T, self.P = int(t["targets"]), int(t["pool_batches"])
        self.kept: list = []
        self.rng = random.Random(stream_seed(run.seed, "kept"))
        run.shapes.update(M=self.M, Nref=self.N, T=self.T)

    def setup(self) -> None:
        # first: a program without the imputer fails here, at once
        from pbwt_tpu_torch.algos.impute import ReferenceImputer
        from pbwt_tpu_torch import tracing
        from pbwt_tpu_torch.core import native, registry
        from pbwt_tpu_torch.core.pbwt import PBWT, Site
        from pbwt_tpu_torch.io.vcf import BLOCK_BYTES
        from pbwt_tpu_torch.ops.build import BlockBuild
        if native.get_lib() is None:
            raise RuntimeError("the port's host C runtime did not build")
        cfg, seed, dev = self.run.config, self.run.seed, self.run.device
        f = Founders(cfg, seed, dev)
        X = f.panel(self.M)
        self.typed = typed_sites(X.sum(0), self.M, cfg, seed)
        build = BlockBuild(self.M, device=dev)
        size = max(32, BLOCK_BYTES // self.M // 32 * 32)
        for s0 in range(0, self.N, size):
            build.add(X[:, s0:s0 + size].t().contiguous().cpu().numpy())
        del X
        vid = registry.variation("A", "G")
        p_ref = PBWT(self.M, self.N)
        p_ref.yz, p_ref.aFend = build.finish()
        p_ref.chrom = CHROM
        p_ref.sites = [Site(x=FIRST_POSITION + POSITION_STEP * k, varD=vid)
                       for k in range(self.N)]
        frame = p_ref.select_sites([p_ref.sites[k] for k in self.typed],
                                   keep_old=True)
        typed = torch.from_numpy(self.typed).to(dev)
        self.pool = [PBWT.from_haplotypes(
            f.queries(self.T, b)[:, typed].cpu().numpy(), chrom=CHROM,
            sites=[s.copy() for s in frame.sites]) for b in range(self.P)]
        del f, typed
        free_device(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.imputer = ReferenceImputer(p_ref, frame, device=dev)
        del p_ref, frame
        # one whole request warms every stage; the frame matcher then learns
        # its record cap on each other batch, so that no request of the
        # window runs K3 again
        before = tracing.counters().get("ops.impute.segments", 0)
        self.imputer.impute(self.pool[0])
        segs = tracing.counters().get("ops.impute.segments", 0) - before
        if self.imputer.matcher is not None:
            for p in self.pool[1:]:
                self.imputer.matcher.match(p.haplotypes())
        # the segments a target set the matcher's rows and K5's work; the
        # mosaic recipe decides them, and no public panel's figure is known
        print(f"pool: {len(self.typed)} typed sites, segments a target "
              f"{segs / self.T:.1f}", file=sys.stderr)

    def hooks(self, spans) -> None:
        """K5's covering pairs, counted from each vote's arguments."""
        from pbwt_tpu_torch.ops import impute
        real = impute.impute_vote
        pairs = spans.counters.setdefault("k5.pairs", [])

        def counted(seg_off, seg_jref, seg_s, seg_e, Xref, kold, ref_freq):
            pairs.append(covering_pairs(kold, seg_s, seg_e))    # on the card
            return real(seg_off, seg_jref, seg_s, seg_e, Xref, kold, ref_freq)
        impute.impute_vote = counted
        spans._undo.append((impute, "impute_vote", real))

    def _keep(self, i: int, b: int, p_new) -> None:
        """Reservoir of the results of kept_results requests."""
        k = int(self.run.traffic["kept_results"])
        if len(self.kept) < k:
            self.kept.append((i, b, p_new))
        else:
            j = self.rng.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, b, p_new)

    def serve(self, client) -> None:
        i = 0
        while True:
            b = i % self.P
            client.request(lambda: self.imputer.impute(self.pool[b]),
                           lambda p_new: self._keep(i, b, p_new),
                           queries=self.T)
            i += 1

    def after_window(self) -> None:
        del self.imputer, self.pool

    def sample(self) -> dict:
        """Batch -> the sorted indices of its sampled targets."""
        rng = random.Random(stream_seed(self.run.seed, "sample"))
        s = int(self.run.traffic["sampled_targets"])
        return {b: sorted(rng.sample(range(self.T), min(s, self.T)))
                for b in range(self.P)}

    def _compare(self, dtype=None, one_per_match: bool = False) -> list:
        """The alleles and dosage codes of the kept results' sampled targets
        against the reference's, and the info scores of the kept results of
        the first kept request's batch against those of the reference's
        whole batch. With dtype (a precision below float64) or
        one_per_match (one haplotype a match: ties dropped), the reference
        made so is put in the program's place."""
        substitute = dtype is not None or one_per_match
        made = {False: {}, True: dict(dtype=dtype or torch.float64,
                                      one_per_match=one_per_match)}
        sample = self.sample()
        batches = sorted({b for _, b, _ in self.kept})
        first = self.kept[0][1] if self.kept else None
        cfg, seed, dev = self.run.config, self.run.seed, self.run.device
        f = Founders(cfg, seed, dev)
        cols = f.panel(self.M).t().contiguous()
        typed = typed_sites(cols.sum(1), self.M, cfg, seed)
        mask = torch.zeros(self.N, dtype=torch.bool, device=dev)
        mask[torch.from_numpy(typed).to(dev)] = True
        Z = torch.cat([f.queries(self.T, b)[sample[b]][:, mask]
                       for b in batches])
        at = np.cumsum([0] + [len(sample[b]) for b in batches])
        ref, info = {}, {}
        for key in sorted({False, substitute}):
            al, co, _, _ = reference.impute(cols, mask, Z, **made[key])
            al, co = al.cpu().numpy(), co.cpu().numpy()
            ref[key] = {b: (al[at[n]:at[n + 1]], co[at[n]:at[n + 1]])
                        for n, b in enumerate(batches)}
            if first is not None:
                whole = reference.impute(
                    cols, mask, f.queries(self.T, first)[:, mask], **made[key])
                # a site no target voted at keeps its score: 0 as made
                info[key] = reference.info_scores(
                    whole[0], whole[2], whole[3]).double().nan_to_num(
                        0.0).cpu().numpy()
                del whole
        del cols, Z
        alleles = codes = compared = 0
        info_diffs = [0.0]
        for _, b, p_new in self.kept:
            want_al, want_co = ref[False][b]
            got_al, got_co = (ref[True][b] if substitute
                              else decoded(p_new, sample[b]))
            alleles += int((got_al != want_al).sum())
            codes += int((got_co != want_co).sum())
            compared += want_al.size
            if b == first:
                got = info[True] if substitute else np.array(
                    [s.imputeInfo for s in p_new.sites])
                info_diffs.append(np.abs(got - info[False]).max())
        limits = self.run.traffic["limits"]
        return [Check("alleles_differing", alleles, limits["alleles_differing"]),
                Check("dosage_codes_differing", codes,
                      limits["dosage_codes_differing"]),
                Check("info_max_abs_diff", float(np.max(info_diffs)),
                      limits["info_max_abs_diff"]),
                Check("nothing_compared", int(compared == 0), 0)]

    def check(self) -> list:
        return self._compare()

    def control(self) -> list:
        """The reference in float32, the precision below the
        configuration's float64: its alleles and codes are float64's (the
        weights' integer sums stay below 2^24), its info scores are not."""
        return self._compare(dtype=torch.float32)
