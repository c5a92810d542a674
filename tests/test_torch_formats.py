"""The port's CLI serves every command of the JAX package's: the command
list and the argument counts read from pbwt_tpu/cli.py, HELP in the JAX
package's wording, the reference's refusal of an unknown command, and the
sidecar, state, subsetting and text-format commands end to end in
subprocesses, on the port's device route with the CPU named
(PBWT_TORCH_DEVICE=cpu: -readVcfq builds on K1's twin) and on its host
engine (0), against python -m pbwt_tpu on its host engine: every file
written and every stdout byte-identical."""

import io
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

import pbwt_tpu.cli as ref_cli
import pbwt_tpu.core.registry as ref_registry
import pbwt_tpu.io.textformats as ref_textformats
import pbwt_tpu.utils as ref_utils
import pbwt_tpu_torch.cli as port_cli
import pbwt_tpu_torch.core.engine as port_engine
import pbwt_tpu_torch.core.registry as port_registry
import pbwt_tpu_torch.io.textformats as port_textformats
import pbwt_tpu_torch.utils as port_utils
from pbwt_tpu_torch.ops import build as port_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the port as `python -m pbwt_tpu_torch ARGS`, then checks that neither
# jax nor the JAX package was imported (tests/test_torch_cli.py's runner)
RUN_PORT = """
import runpy, sys
sys.argv = ["pbwt_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("pbwt_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code
sys.stdout.flush()
alien = sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pbwt_tpu"))
if alien:
    sys.exit("imported: " + " ".join(alien))
sys.exit(rc)
"""


def _run(argv, env_extra, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PBWT_TORCH_DEVICE"}
    env.update(env_extra, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(argv, capture_output=True, env=env, cwd=cwd,
                          timeout=300)


def _panel(seed, M, N, founders=6, switch=0.05):
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return X


# ------------------------------------------------------ the command list

def _jax_commands():
    """{command: need(n)} of every branch of pbwt_tpu/cli.py's loop."""
    with open(os.path.join(ROOT, "pbwt_tpu", "cli.py")) as f:
        text = f.read()
    loop = text[text.index("while argv:"):]
    out = {}
    branches = re.split(r"\n        (?:el)?if cmd ", loop)[1:]
    for branch in branches:
        head, _, body = branch.partition("\n")
        need = re.search(r"need\((\d)\)", body)
        for cmd in re.findall(r'"(-[\w]+)"', head):
            out[cmd] = int(need.group(1)) if need else 0
    return out


def test_cli_serves_every_command_of_the_jax_package():
    """Each command of pbwt_tpu/cli.py is in the port's table with the
    argument count the JAX CLI requires (-merge takes its list of files
    on top)."""
    want = _jax_commands()
    assert len(want) == 72 and "-4hapsStats" in want and want["-siteInfo"] == 3
    assert want == port_cli._NARGS


def test_help_is_the_jax_packages():
    """HELP lists every command in the JAX package's words; only the head
    and the -profile lines are the port's own."""
    port = port_cli.HELP.splitlines()
    ref = ref_cli.HELP.splitlines()
    head = port.index("Commands:")
    assert port[:head] == ["Program: pbwt (PyTorch/CUDA port)",
                           "Usage: python -m pbwt_tpu_torch [ -<command> "
                           "[options]* ]+"]
    body = [ln for ln in port[head:] if "-profile" not in ln
            and "wall time" not in ln]
    ref_body = [ln for ln in ref[ref.index("Commands:"):]
                if "-profile" not in ln and "wall time" not in ln]
    assert body == ref_body and len(body) == 69
    for cmd in _jax_commands():
        assert cmd in port_cli.HELP or cmd.startswith("-writeVcf") \
            or cmd.startswith("-writeBcf")


@pytest.mark.parametrize("argv,message", [
    (["-noSuchCommand"], "unrecognised command -noSuchCommand\n"
                         "Type pbwt without arguments for help"),
    (["word"], "not well formed command word\n"
               "Type pbwt without arguments for help"),
    (["-subrange", "3"], "option -subrange requires 2 argument(s)"),
    (["-readHapLegend", "a", "b"],
     "option -readHapLegend requires 3 argument(s)")])
def test_cli_refusals_are_the_references(argv, message):
    for cli in (port_cli, ref_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert str(e.value.code) == message


# ---------------------------------------------------------- input files

def _write_vcf(path, X, missing):
    """Phased diploid GT records; with ``missing``, a missing allele every
    fifth site."""
    n_s, N = X.shape[0] // 2, X.shape[1]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=20>\n"
                "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"GT\">\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(n_s)) + "\n")
        for k in range(N):
            gts = [f"{X[2 * i, k]}|{X[2 * i + 1, k]}" for i in range(n_s)]
            if missing and k % 5 == 1:
                gts[k % n_s] = ".|1"
            f.write(f"20\t{1000 + 10 * k}\t.\tA\tG\t.\tPASS\t.\tGT\t"
                    + "\t".join(gts) + "\n")


def _write_pl_vcf(path, n_s=3, N=12):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(n_s)) + "\n")
        for k in range(N):
            alt = "G,T" if k == 4 else "G"
            pls = "\t".join(f"{i}/{k % 2}:{k},{i},{k + i}" for i in range(n_s))
            f.write(f"20\t{50 + k}\t.\tA\t{alt}\t.\tPASS\t.\tGT:PL\t{pls}\n")


def _text_inputs(d, X):
    """The text formats of panel X (M, N): vcfq, MaCS, gen, hap,
    hap+legend, PHASE version 2 and version 1."""
    M, N = X.shape
    pos = [700 + 13 * k for k in range(N)]
    with open(d / "q.vcfq", "w") as f:
        for k in range(N):
            f.write(f"20\t{pos[k]}\tA\tC\t"
                    + "\t".join(str(v) for v in X[:, k]) + "\n")
    with open(d / "m.macs", "w") as f:
        f.write(f"COMMAND:\tmacs {M} 1000000\nSEED:\t1\n")
        for k in range(N):
            f.write(f"SITE:\t{k}\t{(k + 0.5) / N:.6f}\t0.5\t"
                    + "".join("01"[v] for v in X[:, k]) + "\n")
        f.write("TOTAL_SAMPLES:\t1\n")
    with open(d / "g.gen", "w") as f:
        for k in range(N):
            g = X[0::2, k] + X[1::2, k]
            probs = " ".join(["1 0 0", "0 1 0", "0 0.4 0.6"][v] for v in g)
            f.write(f"20 rs{k} {pos[k]} A T {probs}\n")
    with open(d / "h.hap", "w") as f:
        for k in range(N):
            f.write(f"20 rs{k} {pos[k]} C G "
                    + " ".join(str(v) for v in X[:, k]) + "\n")
    with open(d / "hl.hap", "w") as f, open(d / "hl.legend", "w") as g:
        g.write("id position a0 a1\n")
        for k in range(N):
            f.write(" ".join(str(v) for v in X[:, k]) + "\n")
            g.write(f"rs{k} {pos[k]} T A\n")
    rows = ["".join("01"[v] for v in X[j]) for j in range(M)]
    with open(d / "v2.phase", "w") as f:
        f.write(f"{M}\n{N}\nP {' '.join(map(str, pos))}\n")
        f.write("\n".join(rows) + "\n")
    with open(d / "v1.phase", "w") as f:
        f.write(f"1\n{M // 2}\n{N}\nP {' '.join(map(str, pos))}\n")
        f.write("S" * N + "\n" + "\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A VCF with missing alleles (60 haplotypes x 80 sites), the text
    formats of a second panel, a sites file to select and one to remove,
    a samples file, reference frequencies, and a fasta index of two
    contigs."""
    d = tmp_path_factory.mktemp("formats")
    X = _panel(31, 60, 80)
    _write_vcf(d / "x.vcf", X, missing=True)
    _text_inputs(d, _panel(32, 90, 70))
    _write_pl_vcf(d / "pl1.vcf", n_s=1)
    _write_pl_vcf(d / "pl.vcf")
    pos = [1000 + 10 * k for k in range(80)]
    with open(d / "sel.sites", "w") as f:
        f.writelines(f"20\t{p}\tA\tG\n" for p in pos[3::2])
    with open(d / "rm.sites", "w") as f:
        f.writelines(f"20\t{p}\tA\tG\n" for p in pos[5::6])
    with open(d / "sel.samples", "w") as f:
        f.writelines(f"s{i}\n" for i in (7, 2, 19, 11, 0, 25))
    with open(d / "rf.txt", "w") as f:
        f.writelines(f"20\t{p}\t{0.01 * (k % 97):.2f}\tA\tG\n"
                     for k, p in enumerate(pos) if k % 3)
    (d / "ref.fa.fai").write_text("20\t64444167\t4\t60\t61\n"
                                  "21\t46709983\t65514356\t60\t61\n")
    return d


# the pipelines, run from a directory of their own beside the inputs
PIPELINES = [
    ["-readVcfGT", "../x.vcf", "-writeSites", "x.sites", "-writeSamples",
     "x.samples", "-writeMissing", "x.missing", "-buildReverse",
     "-writeReverse", "x.rev", "-writeAll", "A", "-referenceFasta",
     "../ref.fa", "-writeVcf", "fa.vcf", "-writeBcf", "fa.bcf"],
    ["-read", "A.pbwt", "-readSites", "x.sites", "-readSamples",
     "x.samples", "-readMissing", "x.missing", "-readReverse", "x.rev",
     "-writeAll", "B", "-writeImputeRef", "IR", "-writeImputeHapsG",
     "ihg.txt", "-writePhase", "wp.phase", "-writeTransposedHaplotypes",
     "th.txt", "-refFreq", "../rf.txt", "-writeGen", "-"],
    ["-readAll", "A", "-subsample", "4", "40", "-subsites", "0.05", "0.6",
     "-subrange", "2", "30", "-writeAll", "S", "-haps", "-"],
    ["-readAll", "A", "-selectSites", "../sel.sites", "-removeSites",
     "../rm.sites", "-selectSamples", "../sel.samples", "-writeAll", "C",
     "-writeGen", "c.gen", "-writeVcf", "-"],
    ["-checkpoint", "7", "-readVcfq", "../q.vcfq", "-writeAll", "Q"],
    ["-readVcfq", "../q.vcfq", "-write", "q2.pbwt", "-readMacs", "../m.macs",
     "-writeAll", "MC", "-readGen", "../g.gen", "20", "-writeAll", "G",
     "-readHap", "../h.hap", "20", "-write", "h.pbwt", "-readHapLegend",
     "../hl.hap", "../hl.legend", "21", "-writeAll", "HL", "-readPhase",
     "../v2.phase", "-writeAll", "P2", "-readPhaseChr", "../v1.phase", "20",
     "-writeAll", "P1", "-writeSites", "-"],
    # -merge with no file and with one leaves the current pbwt as it is
    ["-merge", "-read", "A.pbwt", "-merge", "A.pbwt", "-write", "m1.pbwt",
     "-merge", "A.pbwt", "C.pbwt", "-writeAll", "MG", "-haps", "-"],
    # -readVcfPL prints a sample's PLs; with more than one sample both
    # packages stop on the same error (ROADMAP.md queue 3)
    ["-readVcfPL", "../pl1.vcf", "-readVcfPL", "../pl.vcf"],
]


def _outputs(side, argv0, env, inputs):
    """Each pipeline's exit code, stdout and, where it failed, last line of
    stderr, and the files written."""
    d = inputs / side
    d.mkdir()
    runs = []
    for args in PIPELINES:
        res = _run([*argv0, *args], env, cwd=d)
        runs.append((res.returncode, res.stdout, res.returncode and
                     res.stderr.decode().strip().splitlines()[-1]))
    assert [rc for rc, _, _ in runs] == [0] * (len(PIPELINES) - 1) + [1], runs
    return runs, {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def ref_outputs(inputs):
    return _outputs("ref", [sys.executable, "-m", "pbwt_tpu"],
                    {"PBWT_TPU_DEVICE": "0"}, inputs)


@pytest.mark.parametrize("device", ["cpu", "0"])
def test_cli_formats_equal_host(inputs, ref_outputs, device):
    """Every command of the sidecar, state, subsetting and text-format group
    through the port's CLI: the files and stdout of python -m pbwt_tpu."""
    port = _outputs(f"port_{device}", [sys.executable, "-c", RUN_PORT],
                    {"PBWT_TORCH_DEVICE": device}, inputs)
    files = port[1]
    assert {"x.sites", "x.samples", "x.missing", "x.rev", "A.pbwt",
            "A.reverse", "A.missing", "fa.vcf", "fa.bcf", "B.pbwt",
            "IR.imputeHaps", "IR.imputeLegend", "ihg.txt", "wp.phase",
            "th.txt", "S.pbwt", "C.pbwt", "C.samples", "c.gen", "Q.pbwt",
            "check_A.pbwt", "check_B.pbwt", "q2.pbwt", "MC.pbwt", "G.pbwt",
            "h.pbwt", "HL.pbwt", "P2.pbwt", "P1.sites"} <= files.keys()
    assert b"##contig=<ID=21,length=46709983>" in files["fa.vcf"]
    assert files["Q.pbwt"] == files["q2.pbwt"]
    assert files["m1.pbwt"] == files["A.pbwt"]
    assert struct.unpack("<i", files["MG.pbwt"][4:8]) == (60 + 12,)
    assert [len(out) > 100 for _, out, _ in port[0]] == [
        False, True, True, True, False, True, True, True]
    assert port[0][-1][1].count(b"\n") == 9
    assert port[0][-1][2].startswith("pbwt: invalid literal for int()")
    assert port == ref_outputs


# -------------------------------------- the text importers on the device

@pytest.fixture
def fresh_registries():
    for utils, registry in ((ref_utils, ref_registry),
                            (port_utils, port_registry)):
        registry.init()
        utils.set_log_file(io.StringIO())


@pytest.mark.parametrize("reader,name,chrom", [
    ("read_phase", "v2.phase", "0"), ("read_phase", "v1.phase", "20"),
    ("read_vcfq", "q.vcfq", None)])
def test_text_importers_take_the_device_build(inputs, monkeypatch,
                                              fresh_registries, reader, name,
                                              chrom):
    """-readPhase, -readPhaseChr and -readVcfq with the CPU named build
    through the device engine (K1's twin) once the panel is above
    engine.DEVICE_HAP_SITES (here made small), and give the JAX package's
    PBWT."""
    calls = []
    real = port_build.build_pbwt_device
    monkeypatch.setattr(port_build, "build_pbwt_device", lambda X, device=None:
                        calls.append(X.shape) or real(X, device))
    monkeypatch.setattr(port_engine, "DEVICE_HAP_SITES", 1000)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PBWT_TPU_DEVICE", "0")
    got, want = [], []
    for mod, out in ((port_textformats, got), (ref_textformats, want)):
        with open(inputs / name) as f:
            args = (f,) if chrom is None else (f, chrom)
            p = getattr(mod, reader)(*args)
        out += [p.M, p.N, p.yz, p.aFend.tolist(), p.chrom,
                [(s.x, s.varD) for s in p.sites]]
    assert calls == [(90, 70)]
    assert got == want
