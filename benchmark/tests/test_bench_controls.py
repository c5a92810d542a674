"""Each cell's comparison fails its control and the faults the cell can
have. At toy size on the CPU, through the rest of a run (set-up, window,
check) with the chip's look skipped: the control is the reference put in
the program's place in the precision below the configuration's or with one
of its guarantees broken; each fault is planted in the program underneath."""

import numpy as np
import pytest
import torch

from benchmark import harness

SEED = 2**31 + 29


def run(base, cell, control=False):
    return harness.run_cell(harness.load_cell(cell, base), SEED, 0.3, False,
                            torch.device("cpu"), 0.0, log=lambda *a, **k: None,
                            control=control)


def failed(checks):
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell", ["hrc.match_q1024", "kgp3.match_q256",
                                  "kgp3.copy_model_fit", "hrc.import_blocks"])
def test_control_fails(tiny, cell):
    res = run(tiny, cell, control=True)
    assert res["correct"], res["checks"]
    assert failed(res["control"]), res["control"]


def half_batch_matcher(mp):
    from pbwt_tpu_torch.ops import match
    real = match.DeviceMatcher.match
    mp.setattr(match.DeviceMatcher, "match",
               lambda self, Xq: real(self, Xq[:len(Xq) // 2]))


def altered_rows(mp):
    from pbwt_tpu_torch.ops import match
    real = match.DeviceMatcher.match

    def wrong(self, Xq):
        rows = real(self, Xq).copy()
        rows[::10, 1] = (rows[::10, 1] + 1) % self.M
        return rows
    mp.setattr(match.DeviceMatcher, "match", wrong)


def ll_state_unchanged(mp):
    from pbwt_tpu_torch.ops import likelihood
    real, calls = likelihood.ls_step_plain, [0]

    def step(*args):
        calls[0] += 1
        if calls[0] % 2:
            return real(*args)
    mp.setattr(likelihood, "ls_step_plain", step)


def ll_half_rows(mp):
    from pbwt_tpu_torch.ops import likelihood
    mp.setattr(likelihood, "copy_ll_columns", lambda cols, t, r: 2 * float(
        likelihood.ls_eval(cols, t, r)[:cols.M // 2].sum()))


def ll_altered(mp):
    from pbwt_tpu_torch.ops import likelihood
    real = likelihood.copy_ll_columns
    mp.setattr(likelihood, "copy_ll_columns",
               lambda cols, t, r: real(cols, t, r) * (1 + 1e-6))


def prefix_not_carried(mp):
    from pbwt_tpu_torch.ops import build
    real = build.BlockBuild.add

    def add(self, cols):
        a = self.a
        real(self, cols)
        self.a = a
    mp.setattr(build.BlockBuild, "add", add)


def half_columns_encoded(mp):
    from pbwt_tpu_torch.ops import build
    real = build.encode_columns
    mp.setattr(build, "encode_columns",
               lambda ycols, M: real(ycols[:len(ycols) // 2], M))


def altered_byte(mp):
    from pbwt_tpu_torch.ops import build
    real = build.BlockBuild.finish

    def finish(self):
        yz, a = real(self)
        b = bytearray(yz)
        b[len(b) // 2] ^= 1
        return bytes(b), a
    mp.setattr(build.BlockBuild, "finish", finish)


@pytest.mark.parametrize("cell,fault", [
    ("hrc.match_q1024", half_batch_matcher),
    ("hrc.match_q1024", altered_rows),
    ("kgp3.match_q256", half_batch_matcher),
    ("kgp3.match_q256", altered_rows),
    ("kgp3.copy_model_fit", ll_state_unchanged),
    ("kgp3.copy_model_fit", ll_half_rows),
    ("kgp3.copy_model_fit", ll_altered),
    ("hrc.import_blocks", prefix_not_carried),
    ("hrc.import_blocks", half_columns_encoded),
    ("hrc.import_blocks", altered_byte),
])
def test_fault_fails(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(tiny, cell)
    assert not res["correct"], res["checks"]
    assert failed(res["checks"])
