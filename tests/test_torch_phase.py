"""The port's copies of the host commands that build on no kernel (the
corruption and copy utilities, the genotype comparison, the naive matcher,
-merge, the analyses and the genetic map, phasing) against the JAX
package's, in-process on the same inputs made from a seed: the same pack3
bytes and aFend, the same stdout, the same files. Both packages run on
their host engines; each has its own C runtime and its own glibc rand()
stream, seeded alike before a draw."""

import io
import os

import numpy as np
import pytest

import pbwt_tpu.algos.analyses as ref_analyses
import pbwt_tpu.algos.geneticmap as ref_geneticmap
import pbwt_tpu.algos.impute as ref_impute
import pbwt_tpu.algos.match as ref_match
import pbwt_tpu.algos.merge as ref_merge
import pbwt_tpu.algos.phase as ref_phase
import pbwt_tpu.core.crand as ref_crand
import pbwt_tpu.core.native as ref_native
import pbwt_tpu.core.pbwt as ref_pbwt
import pbwt_tpu.core.registry as ref_registry
import pbwt_tpu.io.pbwtfile as ref_pbwtfile
import pbwt_tpu.io.vcf as ref_vcf
import pbwt_tpu.utils as ref_utils
import pbwt_tpu_torch.algos.analyses as port_analyses
import pbwt_tpu_torch.algos.geneticmap as port_geneticmap
import pbwt_tpu_torch.algos.impute as port_impute
import pbwt_tpu_torch.algos.match as port_match
import pbwt_tpu_torch.algos.merge as port_merge
import pbwt_tpu_torch.algos.phase as port_phase
import pbwt_tpu_torch.core.crand as port_crand
import pbwt_tpu_torch.core.native as port_native
import pbwt_tpu_torch.core.pbwt as port_pbwt
import pbwt_tpu_torch.core.registry as port_registry
import pbwt_tpu_torch.io.pbwtfile as port_pbwtfile
import pbwt_tpu_torch.utils as port_utils

REF = dict(analyses=ref_analyses, geneticmap=ref_geneticmap,
           impute=ref_impute, match=ref_match, merge=ref_merge,
           phase=ref_phase, crand=ref_crand, pbwtfile=ref_pbwtfile,
           registry=ref_registry, pbwt=ref_pbwt)
PORT = dict(analyses=port_analyses, geneticmap=port_geneticmap,
            impute=port_impute, match=port_match, merge=port_merge,
            phase=port_phase, crand=port_crand, pbwtfile=port_pbwtfile,
            registry=port_registry, pbwt=port_pbwt)
SIDES = (("port", PORT), ("ref", REF))


@pytest.fixture(autouse=True)
def host_routes(monkeypatch):
    """Both packages on their host engines with their C runtimes, logs
    discarded, registries and genetic maps fresh."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    monkeypatch.setenv("PBWT_TPU_DEVICE", "0")
    assert port_native.get_lib() is not None and ref_native.get_lib()
    for utils, mods in ((port_utils, PORT), (ref_utils, REF)):
        mods["registry"].init()
        utils.set_log_file(io.StringIO())
        gm = mods["geneticmap"]
        monkeypatch.setattr(gm, "_map", gm.GeneticMap())


def _panel(seed, M, N, founders=6, switch=0.05, noise=0.01):
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return X ^ (rng.random_sample((M, N)) < noise).astype(np.uint8)


def _write_vcf(path, X, pos, names):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=20>\n"
                "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"GT\">\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(names) + "\n")
        for k, x in enumerate(pos):
            gts = "\t".join(f"{X[2 * i, k]}|{X[2 * i + 1, k]}"
                            for i in range(len(names)))
            f.write(f"20\t{x}\t.\tA\tG\t.\tPASS\t.\tGT\t{gts}\n")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Panels written by the JAX package as root.pbwt with .sites and
    .samples: R (80 x 90), T (40 targets typed at every other site of R's),
    and three batches M0-M2 of 20, 30 and 24 haplotypes on overlapping site
    lists, for -merge."""
    d = tmp_path_factory.mktemp("phase")
    X = _panel(41, 120, 90)
    pos = [1000 + 17 * k for k in range(90)]
    panels = {"R": (X[:80], pos), "T": (X[80:][:, ::2], pos[::2]),
              "M0": (X[:20], pos[:70]), "M1": (X[20:50], pos[10:]),
              "M2": (X[50:74][:, ::3], pos[::3])}
    ref_registry.init()
    ref_utils.set_log_file(io.StringIO())
    n = 0
    for root, (Xr, pr) in panels.items():
        names = [f"s{n + i}" for i in range(Xr.shape[0] // 2)]
        n += len(names)
        _write_vcf(d / f"{root}.vcf", Xr, pr, names)
        ref_pbwtfile.write_all(ref_vcf.read_vcf_gt(str(d / f"{root}.vcf")),
                               str(d / root))
    with open(d / "map.txt", "w") as f:
        f.write("Chromosome\tPosition(bp)\tRate(cM/Mb)\tMap(cM)\n")
        for i, x in enumerate(range(900, 2700, 150)):
            f.write(f"chr20\t{x}\t{0.5 + 3.7 * (i % 4):.2f}\t0\n")
    with open(d / "rf.txt", "w") as f:
        f.writelines(f"20\t{x}\t{0.011 * (k % 80):.3f}\tA\tG\n"
                     for k, x in enumerate(pos) if k % 4)
    return d


def _fields(p):
    return (p.M, p.N, p.yz, p.aFend.tolist(), p.chrom,
            None if p.sites is None else [(s.x, s.varD) for s in p.sites],
            p.samples)


def _both(fn, capsys):
    """fn(mods) on each side: (its result, stdout) per side."""
    out = {}
    for side, mods in SIDES:
        res = fn(mods)
        out[side] = res, capsys.readouterr().out
    return out["port"], out["ref"]


# -------------------------------------------------- the glibc rand() stream

def test_crand_hands_off_to_the_c_stream():
    """After srand(s) the port's crand.rand() and its runtime's crand_next
    draw from one stream, interleaved, equal to the JAX package's."""
    lib = port_native.get_lib()
    for seed in (1, 12345):
        port_crand.reset(seed)
        ref_crand.reset(seed)
        got = [port_crand.rand() if i % 3 else lib.crand_next()
               for i in range(300)]
        want = [ref_crand.rand() for _ in range(300)]
        assert got == want
        g = ref_crand.GlibcRand(seed)
        assert want == [g.next() for _ in range(300)]


# ------------------------------------------------------ corruption, copying

@pytest.mark.parametrize("fn,args", [("corrupt_sites", (0.3, 0.05)),
                                     ("corrupt_sites", (1.0, 1.0)),
                                     ("corrupt_samples", (0.25, 0.1)),
                                     ("copy_samples", (50, 20.0)),
                                     ("copy_samples", (7, 1.5))])
def test_corruption_and_copying(roots, capsys, fn, args):
    """Both streams seeded alike: the same panel, byte for byte; the draws
    go on from the same state (the next draw of both is equal)."""
    def run(m):
        m["crand"].reset(5)
        p = m["pbwtfile"].read_all(str(roots / "R"))
        q = getattr(m["impute"], fn)(p, *args)
        return _fields(q), m["crand"].rand()
    port, ref = _both(run, capsys)
    assert port == ref
    assert port[0][0][0] == (args[0] if fn == "copy_samples" else 80)


def test_genotype_compare_after_corruption(roots, capsys):
    """-corruptSites then -genotypeCompare against the original, split on
    sample frequencies and, after -refFreq, on reference frequencies: the
    same report."""
    def run(m):
        m["crand"].reset(1)
        p = m["pbwtfile"].read_all(str(roots / "R"))
        q = m["impute"].corrupt_sites(p, 0.5, 0.2)
        m["impute"].genotype_compare(q, str(roots / "R"))
        with open(roots / "rf.txt") as f:
            m["pbwtfile"].read_ref_freq(q, f)
        m["impute"].genotype_compare(q, str(roots / "R"))
        # a subset of the sites: the frames of both panels are selected
        m["impute"].genotype_compare(q.sub_range(5, 60), str(roots / "R"))
    port, ref = _both(run, capsys)
    assert port == ref
    out = port[1]
    assert out.count("split on sample frequencies") == 1
    assert out.count("split on reference frequencies") == 2


def test_match_naive_callback(roots):
    """-matchNaive of 6 queries, mosaics of the panel's founders with their
    own noise: the same maximal matches, in the same order."""
    rows = {}
    Xq = _panel(41, 6, 90, noise=0.03)
    for side, mods in SIDES:
        p = mods["pbwtfile"].read_all(str(roots / "R"))
        q = mods["pbwt"].PBWT.from_haplotypes(Xq)
        got = []
        mods["match"].match_sequences_naive(p, q,
                                            lambda *r: got.append(r))
        rows[side] = got
    assert len(rows["port"]) > 30 and rows["port"] == rows["ref"]


# ------------------------------------------------------------------- merge

@pytest.mark.parametrize("names", [("M0", "M1", "M2"), ("M1", "M0"),
                                   ("M2", "M2")])
def test_merge(roots, capsys, names):
    """-merge of batches on overlapping site lists: the same union panel,
    sites and pack3 bytes."""
    port, ref = _both(lambda m: _fields(m["merge"].merge(
        [str(roots / f"{n}.pbwt") for n in names])), capsys)
    assert port == ref and port[0][1] > 0


# ----------------------------------------------------------------- phasing

@pytest.mark.parametrize("n_sparse", [1, 2])
def test_phase(roots, capsys, n_sparse):
    """-phase n: the same phased panel and the same phaseCompare report."""
    def run(m):
        m["registry"].is_stats = True
        p = m["pbwtfile"].read_all(str(roots / "R"))
        return _fields(m["phase"].phase(p, n_sparse))
    port, ref = _both(run, capsys)
    assert port == ref


def test_reference_phase(roots, capsys):
    """-referencePhase R on the targets: the same lattice, traceback and
    phased panel."""
    def run(m):
        p = m["pbwtfile"].read_all(str(roots / "T"))
        return _fields(m["phase"].reference_phase(p, str(roots / "R")))
    port, ref = _both(run, capsys)
    assert port == ref and port[0][1] == 45


# --------------------------------------------------------------- analyses

@pytest.mark.parametrize("what", ["sfs", "site_info", "pretty", "explore1",
                                  "explore2", "explore3", "explore4", "play",
                                  "4haps_map", "4haps_linear"])
def test_analyses(roots, capsys, monkeypatch, tmp_path, what):
    """-sfs (stdout and sites.freq), -siteInfo, -pretty, -imputeExplore
    1-4, -play on an imputed panel, and -4hapsStats with a map read by
    -readGeneticMap and with the linear map: the same text."""
    def run(m):
        p = m["pbwtfile"].read_all(str(roots / "R"))
        an = m["analyses"]
        if what == "sfs":
            os.makedirs(m is PORT and "port" or "ref")
            monkeypatch.chdir(m is PORT and "port" or "ref")
            an.site_frequency_spectrum(p)
            with open("sites.freq") as f:
                return f.read()
        if what in ("site_info", "pretty"):
            fp = io.StringIO()
            if what == "site_info":
                an.export_site_info(p, fp, 3, 40)
            else:
                an.pretty_plot(p, fp, 60)
            return fp.getvalue()
        if what.startswith("explore"):
            an.impute_explore(p, int(what[-1]))
            return None
        if what == "play":
            t = m["pbwtfile"].read_all(str(roots / "T"))
            an.play_ground(m["impute"].reference_impute(t, str(roots / "R")))
            return None
        if what == "4haps_map":
            with open(roots / "map.txt") as f:
                m["geneticmap"].read_genetic_map(f)
        m["geneticmap"].pbwt_4haps_stats(p)
        return None
    monkeypatch.chdir(tmp_path)
    port, ref = _both(run, capsys)
    assert port == ref
    assert len(port[1]) + len(port[0] or "") > 20
