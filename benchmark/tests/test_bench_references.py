"""The plain references against answers worked out by brute force, in
Python, at toy sizes."""

import math
import random

import numpy as np
import torch

from benchmark.reference import construction, copy_model
from benchmark.reference.match import set_maximal_rows


def panel(rng, M, N, p=0.3):
    """Random 0/1 rows; rows 0 and 1 all 0 and all 1, so that every allele
    of a query is somewhere in the panel."""
    X = [[int(rng.random() < p) for _ in range(N)] for _ in range(M)]
    X[0], X[1] = [0] * N, [1] * N
    return X


def brute_set_maximal(X, z):
    """Every match of z with a row (a maximal run of equal sites, of length
    one or more) that no other row's match strictly contains."""
    N = len(z)
    runs = []
    for j, x in enumerate(X):
        s = None
        for k in range(N + 1):
            eq = k < N and x[k] == z[k]
            if eq and s is None:
                s = k
            if not eq and s is not None:
                runs.append((j, s, k))
                s = None
    return sorted((j, s, e) for j, s, e in runs
                  if not any(s2 <= s and e2 >= e and (s2, e2) != (s, e)
                             for _, s2, e2 in runs))


def test_matches_brute_force():
    rng = random.Random(5)
    for M, N in ((6, 12), (12, 30), (20, 25)):
        X = panel(rng, M, N)
        Z = [[int(rng.random() < 0.3) for _ in range(N)] for _ in range(4)]
        rows = set_maximal_rows(torch.tensor(X, dtype=torch.uint8).t().contiguous(),
                                torch.tensor(Z, dtype=torch.uint8))
        for q, z in enumerate(Z):
            got = sorted((int(j), int(s), int(e)) for qq, j, s, e in rows if qq == q)
            assert got == brute_set_maximal(X, z), (M, N, q)


def test_matches_control_drops_ties():
    rng = random.Random(6)
    X = panel(rng, 12, 30)
    X[2] = X[3] = [0, 1] * 15
    Z = torch.tensor([[0, 1] * 15], dtype=torch.uint8)
    cols = torch.tensor(X, dtype=torch.uint8).t().contiguous()
    full = set_maximal_rows(cols, Z)
    one = set_maximal_rows(cols, Z, one_per_match=True)
    assert len(one) < len(full)
    assert {tuple(r) for r in one} <= {tuple(r) for r in full}


def brute_pack3(y):
    out = []
    k = 0
    while k < len(y):
        n = 1
        while k + n < len(y) and y[k + n] == y[k]:
            n += 1
        top = y[k] << 7
        k += n
        while n >= 63488:
            out.append(top | 0x7F)
            n -= 63488
        if n >= 2048:
            out.append(top | 0x60 | (n >> 11))
            n &= 0x7FF
        if n >= 64:
            out.append(top | 0x40 | (n >> 6))
            n &= 0x3F
        if n:
            out.append(top | n)
    return bytes(out)


def brute_build(X):
    M, N = len(X), len(X[0])
    a, yz = list(range(M)), b""
    for k in range(N):
        y = [X[i][k] for i in a]
        yz += brute_pack3(y)
        a = [i for i in a if X[i][k] == 0] + [i for i in a if X[i][k] == 1]
    return yz, a


def test_construction_brute_force():
    rng = random.Random(7)
    for M, N in ((5, 9), (40, 70), (300, 20)):
        X = panel(rng, M, N)
        yz, a, marks = construction.build(
            torch.tensor(X, dtype=torch.uint8).t().contiguous(), (0, 7, N))
        assert (yz, list(a)) == brute_build(X)
        head = brute_build([x[:7] for x in X])
        assert marks[7][0] == len(head[0]) and list(marks[7][1]) == head[1]
        assert marks[N][0] == len(yz) and marks[0][0] == 0


def test_pack3_long_runs():
    """Runs past 63,488 and between the tiers' edges, and the one-tier
    control, which differs wherever a run is longer than 63."""
    y = [0] * 70000 + [1] * 2048 + [0] * 64 + [1] * 63 + [0] * 130000 + [1]
    Y = torch.tensor([y], dtype=torch.uint8)
    assert construction.pack3_columns(Y) == brute_pack3(y)
    assert construction.pack3_columns(Y, one_tier=True) != brute_pack3(y)
    assert construction.pack3_columns(Y[:, 70000:70063], one_tier=True) == \
        brute_pack3(y[70000:70063])


def brute_copy_ll(X, theta, rho):
    M, N = len(X), len(X[0])
    left = [[0.0 if i == j else 1.0 / (M - 1) for j in range(M)] for i in range(M)]
    ll = 0.0
    for k in range(N):
        for i in range(M):
            row = [0.0 if i == j else
                   (left[i][j] * (1 - rho) + rho / (M - 1))
                   * ((1 - theta) if X[i][k] == X[j][k] else theta)
                   for j in range(M)]
            s = sum(row)
            ll += math.log(s)
            left[i] = [v / s for v in row]
    return ll


def test_copy_model_brute_force():
    rng = random.Random(8)
    for M, N in ((3, 4), (7, 9), (12, 15)):
        X = [[int(rng.random() < 0.4) for _ in range(N)] for _ in range(M)]
        for theta, rho in ((0.05, 0.01), (0.3, 0.2)):
            want = brute_copy_ll(X, theta, rho)
            got = copy_model.log_likelihood(torch.tensor(X, dtype=torch.uint8),
                                            theta, rho)
            assert abs(got - want) <= 1e-12 * abs(want)
            low = copy_model.log_likelihood(torch.tensor(X, dtype=torch.uint8),
                                            theta, rho, torch.float32)
            assert abs(low - want) <= 1e-5 * abs(want)
