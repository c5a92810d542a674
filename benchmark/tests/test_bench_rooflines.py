"""The rooflines reproduce the bounds in PERF.md."""

from benchmark.rooflines import k1_group_partition, k3_match_scan, k4_ls_eval


def test_k4_bound():
    assert round(1e3 * k4_ls_eval.bound(5008, 1000), 3) == 10.481


def test_k1_bound():
    assert round(1e3 * k1_group_partition.bound(65536, 4096), 4) == 0.0401


def test_k3_bound_by_bytes():
    b, ops = k3_match_scan.work(100000, 2048, 1024, 0)
    assert b > ops / 10                       # the plane's bytes set it
    # the plane once: 2,048 sites x 1,046 blocks of 96 rows (100,352 padded) x 16 bytes
    assert k3_match_scan.plane_bytes(100000, 2048) == 2048 * 1046 * 16
