"""Phasing: within-panel iterative het resolution (phase/phaseSweep,
pbwtImpute.c:288-396) and reference phasing via the pruned HMM lattice
(referencePhase4, pbwtImpute.c:905-1104, EXTEND4 scoring)."""

from __future__ import annotations

import numpy as np

from ..core import engine
from ..core import native, registry
from ..core.pbwt import PBWT
from .. import utils
from ..utils import log, time_update


# --------------------------------------------------------------------------
# phase comparison (phaseCompare, pbwtImpute.c:165-243)
# --------------------------------------------------------------------------

def phase_compare(p: PBWT, q: PBWT) -> None:
    M, N = p.M, p.N
    if q.M != M or q.N != N:
        raise ValueError("size incompatibility in phaseCompare")
    if M % 2:
        raise ValueError(f"phaseCompare requires that M {M} is even")
    from ..core import native
    if p.yz and q.yz:
        # the whole per-pair switch scan as one streaming C pass
        ap0 = (p.aFstart if p.aFstart is not None
               else np.arange(M, dtype=np.int32))
        aq0 = (q.aFstart if q.aFstart is not None
               else np.arange(M, dtype=np.int32))
        (n_switch, n_het, n_switch1, n_switch5, n_switch_sample,
         n_switch_site) = native.phase_compare_core(p.yz, q.yz, M, N, ap0,
                                                    aq0)
        m_fac = 2.0 / M
        log(f"{m_fac * n_switch:.1f} switches per sample, "
            f"{n_switch / n_het if n_het else 0.0:.3f} per het, "
            f"{m_fac * n_switch1:.1f} nSwitch1, "
            f"{m_fac * n_switch5:.1f} nSwitch5")
        if registry.is_stats:
            import sys
            for i in range(M // 2):
                sys.stdout.write(f"SAMPLE-SWITCH\t{i}\t{n_switch_sample[i]}\n")
            for k in range(N):
                sys.stdout.write(f"SITE-SWITCH\t{k}\t{n_switch_site[k]}\n")
        return
    Xp = p.haplotypes()
    Xq = q.haplotypes()
    n_switch = n_het = n_switch1 = n_switch5 = 0
    n_switch_sample = np.zeros(M // 2, dtype=np.int64)
    n_switch_site = np.zeros(N, dtype=np.int64)
    # vectorised over pairs per site (state is sequential in k only)
    is_first = np.ones(M // 2, dtype=bool)
    is_flipped = np.zeros(M // 2, dtype=np.int64)
    last_flip = np.zeros(M // 2, dtype=np.int64)
    k_het = np.zeros(M // 2, dtype=np.int64)
    Xp0, Xp1 = Xp[0::2], Xp[1::2]
    Xq0, Xq1 = Xq[0::2], Xq[1::2]
    for k in range(N):
        xp0 = Xp0[:, k]
        het = (xp0.astype(np.int64) + Xp1[:, k]) == 1
        if not het.any():
            continue
        n_het += int(het.sum())
        k_het[het] += 1
        first = het & is_first
        is_first[first] = False
        is_flipped[first] = (xp0[first] == Xq1[first, k])
        rest = het & ~first
        xq_sel = np.where(is_flipped == 1, Xq1[:, k], Xq0[:, k])
        sw = rest & (xp0 != xq_sel)
        nsw = int(sw.sum())
        if nsw:
            n_switch += nsw
            n_switch_sample[sw] += 1
            n_switch_site[k] = nsw
            gap = k_het[sw] - last_flip[sw]
            n_switch1 += int((gap > 1).sum())
            n_switch5 += int((gap > 5).sum())
            is_flipped[sw] = 1 - is_flipped[sw]
            last_flip[sw] = k_het[sw]
    m_fac = 2.0 / M
    log(f"{m_fac * n_switch:.1f} switches per sample, "
        f"{n_switch / n_het if n_het else 0.0:.3f} per het, "
        f"{m_fac * n_switch1:.1f} nSwitch1, {m_fac * n_switch5:.1f} nSwitch5")
    if registry.is_stats:
        import sys
        for i in range(M // 2):
            sys.stdout.write(f"SAMPLE-SWITCH\t{i}\t{n_switch_sample[i]}\n")
        for k in range(N):
            sys.stdout.write(f"SITE-SWITCH\t{k}\t{n_switch_site[k]}\n")


# --------------------------------------------------------------------------
# within-panel phasing (phase/phaseSweep)
# --------------------------------------------------------------------------

class _SweepCursor:
    """Write cursor with divergence + inverse prefix array (the ->b field)."""

    def __init__(self, M: int, a_init=None):
        self.M = M
        self.a = (np.arange(M, dtype=np.int32) if a_init is None
                  else np.asarray(a_init, np.int32).copy())
        self.d = np.zeros(M + 1, dtype=np.int32)
        self.d[0] = self.d[M] = 1
        self.b = np.empty(M, dtype=np.int32)
        self.b[self.a] = np.arange(M, dtype=np.int32)
        self.chunks: list[bytes] = []

    def write_ad(self, x: np.ndarray, k: int):
        from ..core import pack3 as p3
        y = x[self.a]
        self.chunks.append(p3.pack3(y))
        self.a, self.d = engine.forwards_ad(self.a, self.d, y, k)
        self.b[self.a] = np.arange(self.M, dtype=np.int32)

    def advance_ad_only(self, x: np.ndarray, k: int):
        y = x[self.a]
        self.a, self.d = engine.forwards_ad(self.a, self.d, y, k)
        self.b[self.a] = np.arange(self.M, dtype=np.int32)


def phase_sweep(p: PBWT, ref: PBWT | None, is_start: bool,
                r: PBWT | None, n_sparse: int, score_bit) -> PBWT:
    """phaseSweep (pbwtImpute.c:288-372).

    ``ref`` mirrors the reference's parameter, which its own callers always
    pass as 0 (the ref-panel threshold machinery is dead there too); kept
    for signature parity."""
    M, N = p.M, p.N
    if ref is not None and p.M > ref.M:
        raise ValueError("phaseSweep requires ref->M >= p->M")

    if (ref is None and p.yz
            and (r is None or (r.yz and r.aFend is not None
                               and r.aRend is not None))):
        # one streaming C pass for the whole sweep (phase_sweep_core)
        ap0 = ((p.aFstart if p.aFstart is not None
                else np.arange(M, dtype=np.int32)) if is_start else p.aFend)
        if ap0 is not None:
            thresh = 2 * (n_sparse + (2 if r is not None else 1)) + 0.5
            q = PBWT(M, N)
            if r is not None:
                q.aFstart = r.aFend.copy()
            q.yz, q.aFend, q.aRend = native.phase_sweep_core(
                p.yz, M, N, ap0, is_start,
                r.yz if r is not None else None,
                r.aFend if r is not None else None,
                r.aRend if r is not None else None,
                r.aFend if r is not None else None,
                n_sparse, score_bit, thresh)
            return q

    Y = p.decoded(True)
    # forward/backward reader over p
    if is_start:
        up = engine.ReadCursor(Y, p.aFstart if p.aFstart is not None
                               else np.arange(M, dtype=np.int32))
    else:
        up = engine.ReadCursor(Y, p.aFend)
        up.pos = N

    q = PBWT(M, N)
    ur = None
    r_binv = None
    if r is not None:
        # forward cursor over r at its END; recover stored inverse positions
        ur = engine.ReadCursor(r.decoded(True), r.aFend)
        ur.pos = r.N
        r_binv = r.aRend.copy()          # cached uq->b from the reverse sweep
        q.aFstart = r.aFend.copy()       # prime uq with final ur

    uq = _SweepCursor(M, q.aFstart)
    uqq = [_SweepCursor(M) for _ in range(n_sparse)]

    class _RC:
        """read-cursor adaptor with a/b for the neighbour tables on the
        reverse pbwt"""
        def __init__(self, cur, binv):
            self.cur = cur
            self.b = binv
            self.M = cur.M

        @property
        def a(self):
            return self.cur.a

        @property
        def d(self):
            return self.cur.d

    urw = _RC(ur, r_binv) if ur is not None else None

    x = np.zeros(M, dtype=np.uint8)
    for k in range(N):
        if not is_start:
            up.read_backwards()
        x[up.a] = up.y
        if is_start:
            up.forwards_read()
        xp = np.where(x != 0, 1.0, -1.0)
        hets = np.flatnonzero(x[0::2] != x[1::2]) * 2
        xp[hets] = 0.0
        xp[hets + 1] = 0.0
        thresh = 0.5 if ref is not None else 2 * (n_sparse + (2 if r is not None else 1)) + 0.5
        if len(hets):
            # neighbour tables per cursor: hap ids of the sort-order
            # neighbours and the score1 length weights (exact reference
            # summation order is preserved inside phase_resolve)
            sc1 = [(uq, k)] + [(uqq[j], k // n_sparse)
                               for j in range(n_sparse)]
            curs = sc1 + ([(urw, None)] if urw is not None else [])
            aLs, aRs, wLs, wRs = [], [], [], []
            for c, kc in curs:
                pos = c.b
                al = np.where(pos > 0, c.a[np.maximum(pos - 1, 0)], -1)
                ar = np.where(pos < M - 1, c.a[np.minimum(pos + 1, M - 1)],
                              -1)
                aLs.append(al.astype(np.int32))
                aRs.append(ar.astype(np.int32))
                if kc is not None:
                    d = c.d
                    wLs.append(score_bit[(kc + 1) - d[pos]])
                    wRs.append(score_bit[(kc + 1) - d[pos + 1]])
            native.get_lib().phase_resolve(
                xp, M, len(curs), len(sc1),
                np.ascontiguousarray(np.stack(aLs)),
                np.ascontiguousarray(np.stack(aRs)),
                np.ascontiguousarray(np.stack(wLs)),
                np.ascontiguousarray(np.stack(wRs)), thresh)
        x2 = (xp > 0.0).astype(np.uint8)
        uq.write_ad(x2, k)
        kk = k % n_sparse
        uqq[kk].advance_ad_only(x2, k // n_sparse)
        if ur is not None:
            ur.read_backwards()
            r_binv[ur.a] = np.arange(M, dtype=np.int32)

    q.N = N
    q.yz = b"".join(uq.chunks)
    q.aFend = uq.a.copy()
    q.aRend = uq.b.copy()   # cache inverse for retrieval on the forwards pass
    return q


def phase(p: PBWT, n_sparse: int) -> PBWT:
    """phase (pbwtImpute.c:374-396)."""
    if p.M % 2:
        raise ValueError(f"phase requires that M = {p.M} is even")
    if n_sparse < 2:
        n_sparse = 2
    score_bit = np.log(np.arange(p.N + 2) + 1.0)
    if p.aFend is None:
        p.build_reverse()
    r = phase_sweep(p, None, False, None, 2, score_bit)
    q = phase_sweep(p, None, True, r, n_sparse, score_bit)
    # fprintf without newline (pbwtImpute.c): phaseCompare's stats complete
    # the line
    utils.log_file.write("After forward pass: ")
    phase_compare(p, q)
    q.sites = p.sites
    q.chrom = p.chrom
    q.samples = p.samples
    return q


# --------------------------------------------------------------------------
# reference phasing (referencePhase4, EXTEND4)
# --------------------------------------------------------------------------

def reference_phase4(p_old: PBWT, p_ref: PBWT) -> PBWT:
    log("Reference phase with extension method EXTEND4")
    M_old, N = p_old.M, p_old.N
    M = p_ref.M
    YOld = p_old.decoded(True)
    uold = engine.ReadCursor(YOld, p_old.aFstart)
    n_pairs = M_old // 2

    if p_old.yz and p_ref.yz:
        # the whole forward lattice as one streaming C pass
        # (csrc/pbwt_native.c ref_phase4_core)
        tb, tb_parent, tb_value = native.ref_phase4_core(
            p_old.yz, M_old, p_ref.yz, M, N, p_old.aFstart, p_ref.aFstart)
        tb = tb.copy()
        log(f"traceBackHeap final {len(tb_parent)}, max {len(tb_parent)}")
        for _ in range(N):
            uold.forwards_read()      # traceback walks back from the end
    else:
        tb, tb_parent, tb_value = _phase4_lattice_host(
            p_ref, uold, M_old, M, N, n_pairs)

    # traceback: walk hets backwards from each pair's best final cell
    x_old = np.empty(M_old, dtype=np.uint8)
    p_new = PBWT(M_old, N)
    p_new.aRstart = np.arange(M_old, dtype=np.int32)
    u_new_r = engine.WriteCursor(M_old, p_new.aRstart)
    x_new = np.empty(M_old, dtype=np.uint8)
    for k in range(N - 1, -1, -1):
        uold.read_backwards()
        x_old[uold.a] = uold.y
        for jq in range(0, M_old, 2):
            pr = jq // 2
            if x_old[jq] == x_old[jq + 1]:
                x_new[jq] = x_old[jq]
                x_new[jq + 1] = x_old[jq + 1]
            else:
                node = int(tb[pr])
                if node == 0:
                    raise ValueError(f"premature end of trace back at k {k}")
                x_new[jq] = tb_value[node]
                x_new[jq + 1] = 1 - x_new[jq]
                tb[pr] = tb_parent[node]
    # writes into the reverse pbwt
        u_new_r.write_natural(x_new)
    p_new.zz = u_new_r.packed()
    p_new.aRend = u_new_r.a.copy()
    p_new.aFstart = u_new_r.a.copy()
    # re-reverse to get the forward pbwt
    ur = engine.ReadCursor(p_new.decoded(False), p_new.aRend)
    ur.pos = N
    u_new_f = engine.WriteCursor(M_old, p_new.aFstart)
    xbuf = np.empty(M_old, dtype=np.uint8)
    for k in range(N):
        ur.read_backwards()
        xbuf[ur.a] = ur.y
        u_new_f.write_natural(xbuf)
    p_new.yz = u_new_f.packed()
    p_new.aFend = u_new_f.a.copy()
    return p_new


def _phase4_lattice_host(p_ref: PBWT, uold: "engine.ReadCursor",
                         M_old: int, M: int, N: int, n_pairs: int):
    """Batched-numpy forward lattice of reference_phase4 for panels without
    pack3 bytes; leaves ``uold`` at the end and returns (tb, tb_parent,
    tb_value)."""
    YRef = p_ref.decoded(True)
    uref = engine.ReadCursor(YRef, p_ref.aFstart)

    s = np.zeros((n_pairs, M + 1), dtype=np.float32)
    s[:, 0] = -1.0
    j1 = np.zeros((n_pairs, M + 1), dtype=np.int64)
    dp0 = np.zeros((n_pairs, M + 1), dtype=np.int64)
    dm0 = np.zeros((n_pairs, M + 1), dtype=np.int64)
    dp1 = np.zeros((n_pairs, M + 1), dtype=np.int64)
    dm1 = np.zeros((n_pairs, M + 1), dtype=np.int64)
    back = np.zeros((n_pairs, M + 1), dtype=np.int64)
    # traceback heap: append-only list of (parent, value); node 0 = root
    tb_parent = [0]
    tb_value = [0]

    x_old = np.empty(M_old, dtype=np.uint8)
    jidx = np.arange(M + 1, dtype=np.int64)

    for k in range(N):
        x_old[uold.a] = uold.y
        uref.calculate_u()
        y = uref.y
        u, c = uref.u, uref.c
        d = uref.d
        lib = native.get_lib()
        d32 = np.ascontiguousarray(d, np.int32)
        yc = np.ascontiguousarray(y, np.uint8)
        bp0 = np.empty(M + 1, np.int64); bm0 = np.empty(M + 1, np.int64)
        bp1 = np.empty(M + 1, np.int64); bm1 = np.empty(M + 1, np.int64)
        lib.phase_stop_max(d32, yc, 0, M, bp0, bm0)
        lib.phase_stop_max(d32, yc, 1, M, bp1, bm1)
        bp, bm = [bp0, bp1], [bm0, bm1]
        ymask = np.zeros(M + 2, dtype=np.int64)
        ymask[:M] = y
        jmap = [engine.cursor_map(u, c, 0, jidx), engine.cursor_map(u, c, 1, jidx)]

        # one batched lattice update across all pairs (the reference's
        # per-query step-2 loop, pbwtImpute.c:962-992, vectorised over the
        # global sparse set of live cells x phase orders)
        x0 = x_old[0::2].astype(np.int64)
        x1 = x_old[1::2].astype(np.int64)
        het_p = x0 != x1
        prw, jw = np.nonzero(s)                             # live cells
        bp_t = np.stack(bp)                                 # (2,M+1)
        bm_t = np.stack(bm)
        jmap_t = np.stack(jmap)
        s_l = s[prw, jw]
        oj1_l = j1[prw, jw]
        dp0_l = dp0[prw, jw]; dm0_l = dm0[prw, jw]
        dp1_l = dp1[prw, jw]; dm1_l = dm1[prw, jw]
        back_l = back[prw, jw]
        het_l = het_p[prw]
        nl = len(prw)

        parts = []
        for ph in (0, 1):
            if ph == 0:
                sel = slice(None)
                pr_s, j_s = prw, jw
                xa = x0[prw]; xb = x1[prw]
                s_s, oj1_s = s_l, oj1_l
                dp0_s, dm0_s, dp1_s, dm1_s = dp0_l, dm0_l, dp1_l, dm1_l
                back_s = back_l
            else:
                idx = np.flatnonzero(het_l)
                if not len(idx):
                    continue
                pr_s, j_s = prw[idx], jw[idx]
                xa = x1[pr_s]; xb = x0[pr_s]
                s_s, oj1_s = s_l[idx], oj1_l[idx]
                dp0_s, dm0_s = dp0_l[idx], dm0_l[idx]
                dp1_s, dm1_s = dp1_l[idx], dm1_l[idx]
                back_s = back_l[idx]
            bp_a = bp_t[xa, j_s]
            bm_a = bm_t[xa, j_s]
            bp_b = bp_t[xb, oj1_s]
            bm_b = bm_t[xb, oj1_s]
            tdp0 = np.where(bp_a >= 0, np.maximum(dp0_s, bp_a), dp0_s)
            tdm0 = np.where(bm_a >= 0, np.maximum(dm0_s, bm_a), dm0_s)
            tdp1 = np.where(bp_b >= 0, np.maximum(dp1_s, bp_b), dp1_s)
            tdm1 = np.where(bm_b >= 0, np.maximum(dm1_s, bm_b), dm1_s)
            sign_prev = np.where(ymask[j_s - 1] == xa, 1.0, -1.0)
            sign_next = np.where(ymask[np.minimum(j_s, M - 1)] == xa,
                                 1.0, -1.0)
            ds0 = (np.where(j_s > 0, sign_prev * (k - dm0_s), 0.0)
                   + np.where(j_s < M, sign_next * (k - dp0_s), 0.0))
            sign_prev1 = np.where(ymask[oj1_s - 1] == xb, 1.0, -1.0)
            sign_next1 = np.where(ymask[np.minimum(oj1_s, M - 1)] == xb,
                                  1.0, -1.0)
            ds1 = (np.where(oj1_s > 0, sign_prev1 * (k - dm1_s), 0.0)
                   + np.where(oj1_s < M, sign_next1 * (k - dp1_s), 0.0))
            ts = (s_s + np.minimum(ds0, 0.0).astype(np.float32)
                  + np.minimum(ds1, 0.0).astype(np.float32))
            tgt = jmap_t[xa, j_s]
            nj1 = jmap_t[xb, oj1_s]
            parts.append((pr_s, j_s, np.full(len(pr_s), ph, np.int64),
                          ts, tgt, nj1, tdp0, tdm0, tdp1, tdm1, back_s, xa))

        pr_f = np.concatenate([p[0] for p in parts])
        jj_f = np.concatenate([p[1] for p in parts])
        ph_f = np.concatenate([p[2] for p in parts])
        ts_f = np.concatenate([p[3] for p in parts])
        tg_f = np.concatenate([p[4] for p in parts])
        nj_f = np.concatenate([p[5] for p in parts])
        f0_f = np.concatenate([p[6] for p in parts])
        f1_f = np.concatenate([p[7] for p in parts])
        f2_f = np.concatenate([p[8] for p in parts])
        f3_f = np.concatenate([p[9] for p in parts])
        bk_f = np.concatenate([p[10] for p in parts])
        xa_f = np.concatenate([p[11] for p in parts])
        # winner per (pair, target): max s, ties by (j, phase) arrival order
        order = np.lexsort((ph_f, jj_f, -ts_f, tg_f, pr_f))
        first = np.ones(len(order), dtype=bool)
        first[1:] = ((tg_f[order][1:] != tg_f[order][:-1])
                     | (pr_f[order][1:] != pr_f[order][:-1]))
        win = order[first]

        s[prw, jw] = 0.0
        j1[prw, jw] = 0
        dp0[prw, jw] = 0; dm0[prw, jw] = 0
        dp1[prw, jw] = 0; dm1[prw, jw] = 0
        back[prw, jw] = 0
        wp, wt = pr_f[win], tg_f[win]
        s[wp, wt] = ts_f[win]
        j1[wp, wt] = nj_f[win]
        dp0[wp, wt] = f0_f[win]
        dm0[wp, wt] = f1_f[win]
        dp1[wp, wt] = f2_f[win]
        dm1[wp, wt] = f3_f[win]
        het_w = het_p[wp]
        hidx = np.flatnonzero(het_w)
        back[wp, wt] = bk_f[win]           # hom pairs: copy the back chain
        if len(hidx):
            # het winners allocate traceback nodes recording the chosen phase
            base = len(tb_parent)
            tb_parent.extend(bk_f[win][hidx].tolist())
            tb_value.extend(xa_f[win][hidx].tolist())
            back[wp[hidx], wt[hidx]] = base + np.arange(len(hidx))

        uold.forwards_read()
        uref.forwards_read_ad(k)

    log(f"traceBackHeap final {len(tb_parent)}, max {len(tb_parent)}")

    # pick best final cell per pair
    tb = np.zeros(n_pairs, dtype=np.int64)
    for pr in range(n_pairs):
        live = np.flatnonzero(s[pr] != 0)
        j_best = live[np.argmax(s[pr][live])]
        tb[pr] = back[pr][j_best]
    return tb, tb_parent, tb_value


def reference_phase(p_old: PBWT, root: str) -> PBWT:
    """referencePhase (pbwtImpute.c:1077-1104)."""
    from ..io import pbwtfile
    log(f"phase against reference {root}")
    if p_old.M % 2:
        raise ValueError(f"phase requires that M = {p_old.M} is even")
    if not p_old.yz or p_old.sites is None:
        raise ValueError("referencePhase called without existing pbwt with sites")
    p_ref = pbwtfile.read_all(root)
    if p_ref.sites is None:
        raise ValueError(f"new pbwt {root} in referencePhase has no sites")
    if p_old.chrom != p_ref.chrom:
        raise ValueError(f"mismatching chrom in referencePhase: old "
                         f"{p_old.chrom}, ref {p_ref.chrom}")
    p_old = p_old.select_sites(p_ref.sites, keep_old=False)
    p_ref = p_ref.select_sites(p_old.sites, keep_old=False)
    if not p_old.N:
        raise ValueError("no overlapping sites in referencePhase")
    log("Phase preliminaries: ")
    time_update()
    p_new = reference_phase4(p_old, p_ref)
    log("Phasing complete: ")
    time_update()
    log("After phasing: ")
    phase_compare(p_new, p_old)
    p_new.chrom = p_old.chrom
    p_new.sites = p_old.sites
    p_new.samples = p_old.samples
    return p_new
