"""The port's CLI end to end in a subprocess, on the CPU with the device
route named (PBWT_TORCH_DEVICE=cpu, plain twins) or left to its default:
stdout byte-identical to the JAX package's CLI on its host engine, and
neither jax nor any module of the JAX package imported. A subprocess, because this test process imports both
(tests/conftest.py)."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pbwt_tpu.core.pbwt import PBWT
from pbwt_tpu.io import pbwtfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the port as `python -m pbwt_tpu_torch ARGS`, then checks that neither
# jax nor the JAX package was imported
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


def _queries(Xp, Q, seed):
    r = np.random.RandomState(seed)
    Xq = np.empty((Q, Xp.shape[1]), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < Xp.shape[1]:
            seg = r.randint(8, 30)
            Xq[q, pos:pos + seg] = Xp[r.randint(Xp.shape[0]), pos:pos + seg]
            pos += seg
    return Xq


def _write(path, X):
    with open(path, "wb") as fp:
        pbwtfile.write_pbwt(PBWT.from_haplotypes(X), fp)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    Xp = _panel(3, 600, 80)               # M > 512: the device route
    Xp[17] = Xp[400]
    _write(d / "p.pbwt", Xp)
    _write(d / "q.pbwt", _queries(Xp, 12, 4))
    return str(d / "p.pbwt"), str(d / "q.pbwt")


def _run(argv, env_extra, cwd=ROOT):
    """argv in a subprocess with PBWT_TORCH_DEVICE unset unless given."""
    env = {k: v for k, v in os.environ.items() if k != "PBWT_TORCH_DEVICE"}
    env.update(env_extra)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(argv, capture_output=True, env=env, cwd=cwd,
                          timeout=300)


def _write_vcf(path, X):
    """Phased diploid GT records of haplotype pairs (2i, 2i+1)."""
    n_s, N = X.shape[0] // 2, X.shape[1]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=20>\n"
                "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"GT\">\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(n_s)) + "\n")
        for k in range(N):
            gts = "\t".join(f"{X[2 * i, k]}|{X[2 * i + 1, k]}"
                            for i in range(n_s))
            f.write(f"20\t{1000 + 10 * k}\t.\tA\tG\t.\tPASS\t.\tGT\t{gts}\n")


@pytest.mark.parametrize("budget", [None, "1"])
@pytest.mark.parametrize("cmd", ["-matchDynamic", "-matchIndexed"])
def test_cli_match_equals_host(files, cmd, budget):
    """With a trajectory budget of one byte the matcher walks the panel a
    group of sites a segment: the same stdout."""
    p, q = files
    args = ["-read", p, cmd, q]
    env = {"PBWT_TORCH_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    if budget:
        env["PBWT_TORCH_TRAJ_BYTES"] = budget
    port = _run([sys.executable, "-c", RUN_PORT, *args], env)
    assert port.returncode == 0, port.stderr.decode()
    ref = _run([sys.executable, "-m", "pbwt_tpu", *args],
               {"PBWT_TPU_DEVICE": "0"})
    assert ref.returncode == 0, ref.stderr.decode()
    assert port.stdout.count(b"\n") > 12
    assert port.stdout == ref.stdout


def test_cli_profile_keeps_stdout_and_writes_a_trace(files, tmp_path):
    """-profile <dir>: stdout byte-identical to the run without it, a wall
    line a command in the log (pbwt_tpu/cli.py:556-559's shape), a
    torch.profiler trace in dir and the totals of the port's spans and
    counters beside it; a trace that cannot be written fails the run."""
    p, q = files
    env = {"PBWT_TORCH_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    args = ["-read", p, "-matchDynamic", q]
    plain = _run([sys.executable, "-c", RUN_PORT, *args], env)
    out = tmp_path / "prof"
    prof = _run([sys.executable, "-c", RUN_PORT, "-profile", str(out),
                 *args], env)
    assert plain.returncode == 0 == prof.returncode, prof.stderr.decode()
    assert prof.stdout == plain.stdout and plain.stdout.count(b"\n") > 12
    walls = re.findall(r"^wall\t\d+\.\d{3} s\t(\S+)$",
                       prof.stderr.decode(), re.MULTILINE)
    assert walls == ["-profile", "-read", "-matchDynamic"]
    with open(out / "pbwt_torch_trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ops.match" for e in events)
    lines = (out / "pbwt_torch_spans.tsv").read_text().splitlines()
    assert lines[0] == "kind\tname\tcalls\tseconds\tself_seconds"
    spans = {f[1]: f[2:] for f in map(str.split, lines[1:]) if f[0] == "span"}
    kept = {f[1]: f[2] for f in map(str.split, lines[1:]) if f[0] == "counter"}
    calls, secs, own = spans["ops.match"]
    assert calls == "1" and float(secs) >= float(own) > 0
    assert {"setup.matcher", "ops.match.scan",
            "ops.match.download"} <= set(spans)
    assert kept["ops.match.queries"] == "12"
    assert int(kept["ops.match.rows"]) == sum(
        ln.startswith(b"MATCH\t") for ln in plain.stdout.splitlines())
    (tmp_path / "file").write_text("")
    bad = _run([sys.executable, "-c", RUN_PORT, "-profile",
                str(tmp_path / "file"), *args], env)
    assert bad.returncode != 0 and bad.stdout == b""


def test_cli_device_route_needs_a_card_or_the_cpu_named(files):
    """PBWT_TORCH_DEVICE=1 without a CUDA card is a one-line error, not a
    quiet run of the twins on the CPU."""
    p, q = files
    res = _run([sys.executable, "-c", RUN_PORT, "-read", p, "-matchDynamic",
                q], {"PBWT_TORCH_DEVICE": "1", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 1 and res.stdout == b""
    err = res.stderr.decode().strip().splitlines()
    assert err[-1].startswith("pbwt: no CUDA device")
    assert "PBWT_TORCH_DEVICE=cpu" in err[-1]


def test_cli_host_route_imports_no_torch(files):
    """PBWT_TORCH_DEVICE=0: a command that stays on the host engine does not
    pay for importing torch."""
    p, q = files
    script = RUN_PORT.replace('("jax", "jaxlib", "pbwt_tpu")',
                              '("jax", "jaxlib", "pbwt_tpu", "torch")')
    assert script != RUN_PORT
    res = _run([sys.executable, "-c", script, "-read", p, "-matchDynamic", q],
               {"PBWT_TORCH_DEVICE": "0"})
    assert res.returncode == 0, res.stderr.decode()
    assert res.stdout.count(b"\n") > 12


def test_cli_refuses_other_commands(files):
    """A command that neither CLI has stops with the reference's words."""
    p, _ = files
    res = _run([sys.executable, "-c", RUN_PORT, "-read", p, "-5hapsStats"],
               {})
    assert res.returncode != 0
    last = res.stderr.decode().strip().splitlines()[-2:]
    assert last == ["unrecognised command -5hapsStats",
                    "Type pbwt without arguments for help"]


@pytest.fixture(scope="module")
def ll_panel(tmp_path_factory):
    """A mosaic panel with 1% allele noise: without noise theta runs to 0
    and the -llCopyModel fit takes about four times the evaluations."""
    X = _panel(11, 40, 30)
    X ^= (np.random.RandomState(12).random_sample(X.shape) < 0.01
          ).astype(np.uint8)
    path = tmp_path_factory.mktemp("ll") / "p.pbwt"
    _write(path, X)
    return str(path)


def _port_and_host(args, port_env):
    """stdout of the port's CLI (with port_env) and of the host CLI."""
    port = _run([sys.executable, "-c", RUN_PORT, *args],
                dict(port_env, OMP_NUM_THREADS="1"))
    host = _run([sys.executable, "-m", "pbwt_tpu", *args],
                {"PBWT_TPU_DEVICE": "0"})
    for res in (port, host):
        assert res.returncode == 0, res.stderr.decode()
    return port.stdout.decode(), host.stdout.decode()


@pytest.mark.parametrize("args", [["-fitAlphaBeta", "1"],
                                  ["-fitAlphaBeta", "2"],
                                  ["-llCopyModel", "0.05", "0.01"]])
def test_cli_likelihood_equals_host(ll_panel, args):
    """-fitAlphaBeta is the host's code, and -llCopyModel runs on the host
    without a card and PBWT_TORCH_DEVICE unset: stdout byte-identical."""
    port, host = _port_and_host(["-read", ll_panel, *args], {})
    assert port.count("\n") >= 2
    assert port == host


NUMBER = re.compile(r"-?\d+\.\d+")


def test_cli_llcopymodel_device_route(ll_panel):
    """PBWT_TORCH_DEVICE=cpu: the fit runs on K4's twin, whose row sums are
    the host's bit for bit. stdout is the host's, byte for byte."""
    port, host = _port_and_host(["-read", ll_panel, "-llCopyModel", "0.05",
                                 "0.01"],
                                {"PBWT_TORCH_DEVICE": "cpu",
                                 "CUDA_VISIBLE_DEVICES": ""})
    first, fit = ([float(v) for v in NUMBER.findall(line)]
                  for line in port.splitlines())
    assert first[:2] == [0.05, 0.01] and len(fit) == 4
    assert port == host


def test_cli_io_commands_equal_host(tmp_path):
    """The port's I/O commands write the same files and stdout as the JAX
    package's CLI."""
    _write_vcf(tmp_path / "x.vcf", _panel(5, 600, 40))
    pipelines = [["-readVcfGT", "../x.vcf", "-check", "-stats", "-log",
                  "l.txt", "-write", "o.pbwt", "-writeAll", "r", "-haps",
                  "h.txt"],
                 ["-readAll", "r", "-write", "o2.pbwt", "-haps", "-"]]
    outs = {}
    for side, argv0, env in (
            ("port", [sys.executable, "-c", RUN_PORT],
             {"PBWT_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}),
            ("host", [sys.executable, "-m", "pbwt_tpu"],
             {"PBWT_TPU_DEVICE": "0"})):
        d = tmp_path / side
        d.mkdir()
        stdout = []
        for args in pipelines:
            res = _run([*argv0, *args], env, cwd=d)
            assert res.returncode == 0, res.stderr.decode()
            stdout.append(res.stdout)
        outs[side] = stdout, {f: (d / f).read_bytes()
                              for f in sorted(os.listdir(d)) if f != "l.txt"}
    assert outs["port"][1].keys() == {"o.pbwt", "o2.pbwt", "r.pbwt",
                                      "r.samples", "r.sites", "h.txt"}
    assert outs["port"] == outs["host"]


@pytest.mark.parametrize("device", ["cpu", "0"])
def test_cli_reference_impute_and_writers_equal_host(tmp_path, device):
    """-referenceImpute on the device route (K5's twin) and on the port's
    host route, then every writer of the imputed pbwt: the files and stdout
    of the JAX package's CLI, byte for byte; the optional nSparse and
    fSparse words are taken."""
    Xref = _panel(21, 60, 90, switch=0.03)
    Xt = _queries(Xref, 8, 22)
    Xt ^= (np.random.RandomState(23).random_sample(Xt.shape) < 0.02
           ).astype(np.uint8)
    _write_vcf(tmp_path / "ref.vcf", Xref)
    # the targets are typed at every third site only
    lines = (tmp_path / "ref.vcf").read_text().splitlines()
    _write_vcf(tmp_path / "all.vcf", Xt)
    body = (tmp_path / "all.vcf").read_text().splitlines()
    assert len(lines) == len(body) == 4 + 90
    (tmp_path / "tgt.vcf").write_text(
        "\n".join(body[:4] + body[4::3]) + "\n")
    pipelines = [["-readVcfGT", "../ref.vcf", "-writeAll", "R"],
                 ["-readVcfGT", "../tgt.vcf", "-referenceImpute", "R",
                  "-writeAll", "OUT", "-writeVcf", "o.vcf", "-writeVcfGz",
                  "o.vcf.gz", "-writeBcf", "o.bcf", "-writeBcfGz",
                  "o.bcf.gz", "-writeGen", "o.gen", "-writeDosage",
                  "o.dosage"],
                 ["-readAll", "OUT", "-readDosage", "o.dosage", "-writeVcf",
                  "-"],
                 ["-readVcfGT", "../tgt.vcf", "-referenceImpute", "R", "2",
                  "0.5", "-write", "o3.pbwt", "-haps", "-"]]
    outs = {}
    for side, argv0, env in (
            ("port", [sys.executable, "-c", RUN_PORT],
             {"PBWT_TORCH_DEVICE": device, "CUDA_VISIBLE_DEVICES": "",
              "OMP_NUM_THREADS": "1"}),
            ("host", [sys.executable, "-m", "pbwt_tpu"],
             {"PBWT_TPU_DEVICE": "0"})):
        d = tmp_path / side
        d.mkdir()
        stdout = []
        for args in pipelines:
            res = _run([*argv0, *args], env, cwd=d)
            assert res.returncode == 0, res.stderr.decode()
            stdout.append(res.stdout)
        outs[side] = stdout, {f: (d / f).read_bytes()
                              for f in sorted(os.listdir(d))}
    assert {"OUT.pbwt", "OUT.sites", "OUT.dosage", "OUT.samples", "o.vcf",
            "o.vcf.gz", "o.bcf", "o.bcf.gz", "o.gen", "o.dosage",
            "o3.pbwt"} <= outs["port"][1].keys()
    assert b"DR2=" in outs["port"][0][2] and b":ADS:DS:GP" in outs["port"][0][2]
    assert outs["port"][1]["OUT.pbwt"] == outs["port"][1]["o3.pbwt"]
    assert outs["port"] == outs["host"]
