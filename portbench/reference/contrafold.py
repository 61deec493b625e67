"""The check's CONTRAfold v2 inside-outside: a frozen copy of the port's
`dafs_tpu_torch/ops/contrafold.py`, plain PyTorch, with no span.

It follows contrafold/InferenceEngine.ipp: ComputeInside (:3356-3722),
ComputeOutside (:3731-4490) and ComputePosterior (:4498+), for the DAFS
configuration (helix-length and isolated-pair features off, max_bp_dist=0,
complementary pairs only).  The sequences of one 32-length bucket run as
one batch on `device`, as in the port, so that both compute the same
batches.

Layout: log-domain tables FC/FM/FM1 over (L+2)^2 cells, filled one
diagonal (span d = j - i) per step, with diagonal-major shadows
D[e, a] = M[a, a+e] so that a step reads whole rows.  FC(i, j) is the score
of the region closed by the pair (i, j+1).  Per step:

- the single-branch loops (stacks, bulges, interior loops) as a bounded
  31x31 stencil over the split sizes (l1, l2), l1 + l2 <= MAXS = 30, read
  from the shadows by one gather per table;
- the multiloop split FM2(i, j) = sum over k of FM1(i, k) FM(k, j), a masked
  reduction over a row-major window;
- the outside pass keeps the O(L^3) FM2 adjoints in two running
  accumulators (A_FM1, A_FM) instead of upstream's rolling pointers.

The pair posterior is exp(FCi + FCo - Z) at the pair's FC cell, gated at
-60 and clipped to [0, 1]: every pair production routes through FC with the
pair's own scores applied by the producing context, so this equals
upstream's per-production sum.

Departure from upstream, inherited from the port: every reduction is an
exact log-sum-exp (`torch.log1p`, `torch.exp`), guarded for the -2e20
sentinel, where upstream takes its piecewise-cubic Fast_LogPlusEquals
(about 1e-5 apart in log space).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import contrafold_params as CF
from portbench.reference import params

NEG = float(np.float32(-2e20))
GUARD = float(np.float32(-1e19))  # values at or below it are sentinels
MAXS = 30  # C_MAX_SINGLE_LENGTH
SW = MAXS + 1


def _round_up(n, m):
    return -(-n // m) * m


def _lse(a, b):
    """logaddexp guarded for the NEG sentinel."""
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return torch.where(lo > GUARD, hi + torch.log1p(torch.exp(lo - hi)), hi)


def _lse_reduce(x, dim):
    hi = torch.amax(x, dim=dim, keepdim=True)
    out = hi.squeeze(dim) + torch.log(
        torch.sum(torch.exp(x - torch.clamp(hi, min=GUARD)), dim=dim))
    return torch.where(hi.squeeze(dim) > GUARD, out, NEG)


def tables(device) -> dict[str, torch.Tensor]:
    """CONTRAfold v2 tables on `device` (`contrafold_params.tables()`), the
    five loop weights as 0-dim tensors."""
    return params.to_device(CF.tables(), device)


def _shl(x, k, fill):
    """out[..., i] = x[..., i + k], `fill` beyond the end."""
    if k == 0:
        return x
    return torch.cat([x[..., k:], torch.full_like(x[..., :k], fill)], dim=-1)


def _shr(x, k, fill):
    """out[..., i] = x[..., i - k], `fill` before the start."""
    if k == 0:
        return x
    return torch.cat([torch.full_like(x[..., :k], fill), x[..., :-k]], dim=-1)


def inside_outside(S, allow_pair, allow_unpaired, n, tab):
    """Pair posteriors of a batch of sequences, (B, L+2, L+2).

    S (B, L+2): codes 1-based (index 0 and the positions beyond each length
    hold 4); allow_pair (B, L+2, L+2) bool, upper triangle; allow_unpaired
    (B, L+2) bool; n (B,) true lengths; tab from `tables`."""
    B, A = S.shape
    L = A - 2
    dev = S.device
    S = S.long()
    nb = n.long()[:, None]         # (B, 1)
    nbb = nb[:, :, None]           # (B, 1, 1)
    au = allow_unpaired
    idx = torch.arange(A, device=dev)
    lane = idx[None, :]            # (1, A): cell i of a diagonal
    a_, b_ = idx[:, None], idx[None, :]
    t_bp, t_tm, t_hs = tab["base_pair"], tab["terminal_mismatch"], tab["helix_stacking"]
    t_hc, t_dl, t_dr = tab["helix_closing"], tab["dangle_left"], tab["dangle_right"]
    t_b0x1, t_i1x1 = tab["bulge_0x1"], tab["internal_1x1"]
    t_hairpin_len, t_single = tab["hairpin_len"], tab["single"]
    mb, mp_, mu = tab["multi_base"], tab["multi_paired"], tab["multi_unpaired"]
    ep_, eu = tab["external_paired"], tab["external_unpaired"]

    def cl(x):
        return x.clamp(0, A - 1)

    # segment-unpaired gates: seg_ok[a, b] when every position of [a, b]
    # may be unpaired (or the segment is empty)
    logv = torch.where((lane >= 1) & (lane <= nb) & au, 1.0, 0.0)
    blocked = torch.cumsum(torch.where(lane >= 1, 1.0 - logv, 0.0), dim=1)
    seg_blocked = blocked[:, None, :] - blocked[:, cl(idx - 1)][:, :, None]
    seg_ok = ((b_ - a_ + 1) <= 0)[None] | (seg_blocked == 0)

    sa, sb = S[:, :, None], S[:, None, :]
    sa1, sb1 = S[:, cl(idx + 1)][:, :, None], S[:, cl(idx + 1)][:, None, :]
    sb2 = S[:, cl(idx + 2)][:, None, :]
    sam1 = S[:, cl(idx - 1)][:, :, None]

    # ---- pair-indexed score planes, (B, A, A) -------------------------------
    JBP = t_hc[sa, sb1] + t_tm[sa, sb1, sa1, sb]           # JB(a, b)
    JAP = (t_hc[sa, sb1]
           + torch.where(a_ < nbb, t_dl[sa, sb1, sa1], 0.0)
           + torch.where(b_ > 0, t_dr[sa, sb1, sb], 0.0))  # JA(a, b)
    BPP = t_bp[sa, sb]
    BPX = t_bp[sa, sb1]                                     # t_bp[S[a], S[b+1]]
    HSP = t_hs[sa, sb1, sa1, sb]
    STK = t_bp[sa1, sb] + HSP                               # inside stack at (a, b)
    # single-branch inner side at split (p, q): t_bp[S[p+1], S[q]] + JB(q, p)
    INB = t_bp[sa1, sb] + JBP.transpose(1, 2)
    JIN = t_hc[sb1, sa] + t_tm[sb1, sa, sb2, sam1]          # outside JB of the inner pair
    P11 = t_i1x1[sa, sb]
    M11i = t_i1x1[sa1, sb]                                  # t_i1x1[S[a+1], S[b]]
    vb0x1 = t_b0x1[S]                                       # (B, A)
    vb0x1s = vb0x1[:, cl(idx + 1)]                          # t_b0x1[S[a+1]]
    vb0x1r = vb0x1[:, cl(idx - 1)]                          # t_b0x1[S[a-1]]

    def rowshift(M):
        """M[a+1, b], the last row repeated."""
        return torch.cat([M[:, 1:], M[:, -1:]], dim=1)

    e_rows = idx[:, None].expand(A, A)
    a_cols = idx[None, :].expand(A, A)

    def diag(M):
        """D[e, a] = M[a, a+e]; zero/False where a+e is past M's columns."""
        cols = e_rows + a_cols
        g = M[:, a_cols, cols.clamp(max=M.shape[-1] - 1)]
        return torch.where(cols < M.shape[-1], g, torch.zeros_like(g))

    JBD, JAD, JARD = diag(JBP), diag(JAP), diag(JAP.transpose(1, 2))
    BP1D = diag(rowshift(BPP))       # BPP[a+1, a+e]
    BPXD, STKD, INBD = diag(BPX), diag(STK), diag(INB)
    JIND, HSPD, P11D, M11D = diag(JIN), diag(HSP), diag(P11), diag(M11i)
    APD = diag(allow_pair)           # ap[a, a+e]
    AP1D = diag(allow_pair[:, :, 1:])  # ap[a, a+e+1]
    AP2D = diag(rowshift(allow_pair))  # ap[a+1, a+e]
    SEGHD = diag(rowshift(seg_ok))     # seg_ok[a+1, a+e]

    # per-l1 / per-l2 segment gates of the single-branch stencil, (B, 31, A)
    ll = torch.arange(SW, device=dev)[:, None]
    ii = idx[None, :]
    SEGA = seg_ok[:, cl(ii + 1).expand(SW, A), cl(ii + ll)]  # [l1, i] = seg[i+1, i+l1]
    SEGB = seg_ok[:, cl(ii - ll + 1), ii.expand(SW, A)]      # [l2, b] = seg[b-l2+1, b]
    SEGC = seg_ok[:, cl(ii - ll), cl(ii - 1).expand(SW, A)]  # [l1, i] = seg[i-l1, i-1]
    SEGD = SEGA                                              # [l2, b] = seg[b+1, b+l2]

    # the (l1, l2, i) grids of the stencil, and flat offsets into an (A, A)
    # shadow: inside reads the inner FC cell (row d-2-u, column i+l1+1), the
    # inner-side scores (d-u, i+l1) and ap (d-1-u, i+l1+1); outside reads the
    # outer FCo cell, JB and ap at (d+2+u, i-l1-1).  u = l1 + l2.
    l1g = torch.arange(SW, device=dev)[:, None, None]
    l2g = torch.arange(SW, device=dev)[None, :, None]
    ig = idx[None, None, :]
    ug = l1g + l2g
    in_col = ig + l1g + 1
    K_fc = (-2 - ug) * A + in_col
    K_inb = (-ug) * A + (in_col - 1)
    K_ap = (-1 - ug) * A + in_col
    out_col = ig - l1g - 1
    K_out = (2 + ug) * A + out_col
    in_ok = (ug <= MAXS) & (in_col < A)
    out_ok = (ug <= MAXS) & (ig >= l1g + 2)
    t_single_g = t_single[None, :, :, None]

    def gather(D, K, d):
        """D[:, e, a] at the flat offsets K + d*A (clamped; the callers mask
        the cells whose offset left the table)."""
        flat = (K + d * A).clamp(0, A * A - 1).reshape(-1)
        return D.reshape(B, A * A)[:, flat].reshape(B, SW, SW, A)

    def row(D, e):
        return D[:, max(e, 0)]

    negrow = torch.full((B, A), NEG, dtype=torch.float32, device=dev)

    # ---------------- inside --------------------------------------------------
    FM = torch.full((B, A, A), NEG, dtype=torch.float32, device=dev)
    FM1 = FM.clone()
    FCD, FMD, FM1D = FM.clone(), FM.clone(), FM.clone()
    for d in range(L):
        w = A - d  # cells (i, i + d) that lie in the table
        iw = idx[:w]
        fc_ok = (lane >= 1) & (lane + d <= nb - 1) & AP1D[:, d]

        # FM2(i, i+d) = lse over i < k < i+d of FM1[i, k] + FM[k, i+d]
        FMwin = FM.transpose(1, 2)[:, d:, :]  # [i, k] = FM[k, i+d]
        kmask = (b_ > a_) & (b_ < a_ + d)
        FM2 = torch.cat([
            _lse_reduce(torch.where(kmask[:w], FM1[:, :w] + FMwin, NEG), dim=2),
            negrow[:, w:]], dim=1)

        hp = torch.where(SEGHD[:, d], JBD[:, d] + t_hairpin_len[min(d, MAXS)], NEG)

        # single-branch loops incl. stacking, [l1, l2, i] layout
        FCIN = gather(FCD, K_fc, d)
        INBIN = gather(INBD, K_inb, d)
        APIN = gather(APD, K_ap, d)
        sc = t_single_g + INBIN + JBD[:, d][:, None, None, :]
        sc[:, 0, 1] += _shl(vb0x1, d, 0.0)
        sc[:, 1, 0] += vb0x1s
        sc[:, 1, 1] += M11D[:, d]
        sc[:, 0, 0] = STKD[:, d]
        ok = in_ok & (ug <= d - 2) & APIN & SEGA[:, :, None, :]
        ok &= _shl(SEGB, d, False)[:, None, :, :]
        single_sum = _lse_reduce(
            torch.where(ok, FCIN + sc, NEG).reshape(B, SW * SW, A), dim=1)

        multi = FM2 + JAD[:, d] + mp_ + mb
        fc_new = torch.where(fc_ok, _lse(_lse(hp, single_sum), multi), NEG)
        FCD[:, d] = fc_new

        # FM1(i, i+d): the stem closed by the pair (i+1, i+d), or i+1
        # unpaired and FM1(i+1, i+d)
        fm1_ok = (lane >= 1) & (d >= 2) & (lane + d <= nb - 1)
        fc_in = _shl(FCD[:, d - 2] if d >= 2 else negrow, 1, NEG)
        stem = torch.where(AP2D[:, d], fc_in + JARD[:, d] + mp_ + BP1D[:, d], NEG)
        shift = torch.where(_shl(au, 1, False), _shl(row(FM1D, d - 1), 1, NEG) + mu, NEG)
        fm1_new = torch.where(fm1_ok, _lse(stem, shift), NEG)
        FM1[:, iw, iw + d] = fm1_new[:, :w]
        FM1D[:, d] = fm1_new

        # FM(i, i+d)
        fm_new = _lse(FM2, torch.where(_shl(au, d, False), row(FMD, d - 1) + mu, NEG))
        fm_new = torch.where(fm1_ok, _lse(fm_new, fm1_new), NEG)
        FM[:, iw, iw + d] = fm_new[:, :w]
        FMD[:, d] = fm_new

    # row-major FC[a, b] = FCD[b - a, a]
    e_plane = b_ - a_

    def undiag(D):
        return torch.where(e_plane >= 0, D[:, e_plane.clamp(0, A - 1), a_.expand(A, A)], NEG)

    FC = undiag(FCD)

    # ---------------- F5 ------------------------------------------------------
    FCr = torch.cat([FC[:, 1:], negrow[:, None]], dim=1)  # FC(a+1, b)
    BPr = rowshift(BPP)                                      # BP(a+1, b)
    APr = rowshift(allow_pair)                               # ap(a+1, b)
    F5 = negrow.clone()
    F5[:, 0] = 0.0
    for j in range(1, L + 1):
        unp = torch.where(au[:, j], F5[:, j - 1] + eu, NEG)
        terms = torch.where(
            (idx < j) & APr[:, :, j],
            F5 + FCr[:, :, j - 1] + ep_ + BPr[:, :, j] + JAP[:, j, :],
            NEG,
        )
        val = _lse(unp, _lse_reduce(terms, dim=1))
        F5[:, j] = torch.where(j <= nb[:, 0], val, NEG)
    b_ar = torch.arange(B, device=dev)
    Z = F5[b_ar, n.long()]

    # ---------------- outside -------------------------------------------------
    F5o = negrow.clone()
    F5o[b_ar, n.long()] = 0.0
    for k in range(L - 1, -1, -1):
        unp = torch.where(au[:, k + 1], F5o[:, k + 1] + eu, NEG)
        terms = torch.where(
            (lane > k) & (lane <= nb) & APr[:, k, :],
            F5o + _shr(FCr[:, k, :], 1, NEG) + ep_ + BPr[:, k, :] + JAP[:, :, k],
            NEG,
        )
        val = _lse(unp, _lse_reduce(terms, dim=1))
        F5o[:, k] = torch.where(k < nb[:, 0], val, F5o[:, k])

    # FCo seeded by the external-stem production
    fco_init = torch.where(
        (a_ >= 1) & (b_ >= a_) & (b_ <= nbb - 1) & allow_pair[:, :, cl(idx + 1)],
        F5o[:, cl(idx + 1)][:, None, :] + F5[:, cl(idx - 1)][:, :, None] + ep_
        + BPX + JAP[:, cl(idx + 1)[None, :], cl(idx - 1)[:, None]],
        NEG,
    )
    FCOID = diag(fco_init)

    FCoD, FMoD, FM1oD = FM.clone().fill_(NEG), FM.clone().fill_(NEG), FM.clone().fill_(NEG)
    A_FM1, A_FM = FM.clone().fill_(NEG), FM.clone().fill_(NEG)
    for d in range(L - 1, -1, -1):
        w = A - d
        fc_ok = (lane >= 1) & (lane + d <= nb - 1) & AP1D[:, d]

        # FCo: external seed + single-branch loop from an outer FC + the FM1
        # production
        FCOIN = gather(FCoD, K_out, d)
        JBIN = gather(JBD, K_out, d)
        APIN = gather(AP1D, K_out, d)
        bp_row = BPXD[:, d]                          # t_bp[S[i], S[i+d+1]]
        sc2 = t_single_g + bp_row[:, None, None, :] + JBIN
        sc2 = sc2 + JIND[:, d][:, None, None, :]
        sc2[:, 0, 1] += _shl(vb0x1, d + 2, 0.0)
        sc2[:, 1, 0] += vb0x1r
        sc2[:, 1, 1] += _shr(P11D[:, min(d + 3, A - 1)], 1, 0.0)
        sc2[:, 0, 0] = bp_row + _shr(HSPD[:, d + 2], 1, 0.0)
        ok = out_ok & (ig + d + 1 + l2g <= nbb[:, :, :, None] - 1) & APIN
        ok &= (2 + ug + d < A) & SEGC[:, :, None, :] & _shl(SEGD, d, False)[:, None, :, :]
        fco = _lse(FCOID[:, d], _lse_reduce(
            torch.where(ok, FCOIN + sc2, NEG).reshape(B, SW * SW, A), dim=1))

        # FM1 production: FM1o(i-1, i+d+1) -> FC(i, i+d)
        fm1_src = torch.where(
            (lane - 1 >= 1) & AP1D[:, d],
            _shr(FM1oD[:, d + 2], 1, NEG) + _shr(JARD[:, d + 2], 1, 0.0) + mp_ + bp_row,
            NEG,
        )
        fco = torch.where(fc_ok, _lse(fco, fm1_src), NEG)
        FCoD[:, d] = fco

        cell_ok = (lane >= 1) & (d >= 2) & (lane + d <= nb - 1)
        afm_diag = torch.cat([torch.diagonal(A_FM, offset=d, dim1=1, dim2=2), negrow[:, w:]], dim=1)
        afm1_diag = torch.cat([torch.diagonal(A_FM1, offset=d, dim1=1, dim2=2), negrow[:, w:]], dim=1)

        fmo = _lse(afm_diag, torch.where(_shl(au, d + 1, False), FMoD[:, d + 1] + mu, NEG))
        fmo = torch.where(cell_ok, fmo, NEG)
        FMoD[:, d] = fmo

        fm1o = _lse(afm1_diag, fmo)
        fm1o = _lse(fm1o, torch.where(au, _shr(FM1oD[:, d + 1], 1, NEG) + mu, NEG))
        fm1o = torch.where(cell_ok, fm1o, NEG)
        FM1oD[:, d] = fm1o

        # adjoints of FM2(i, i+d) = sum over k of FM1(i, k) FM(k, i+d): the
        # targets have strictly smaller spans, so they are final before use
        G = _lse(fmo, torch.where(fc_ok, fco + JAD[:, d] + mp_ + mb, NEG))
        gmask = ((b_ > a_) & (b_ < a_ + d))[:w]
        Gw = G[:, :w, None]
        FMwin = FM.transpose(1, 2)[:, d:, :]  # [i, k] = FM[k, i+d]
        A_FM1[:, :w] = _lse(A_FM1[:, :w], torch.where(gmask, Gw + FMwin, NEG))
        # A_FM[k, i+d] lse= G[i] + FM1[i, k]
        upd2 = torch.where(gmask, Gw + FM1[:, :w], NEG)
        A_FM[:, :, d:] = _lse(A_FM[:, :, d:], upd2.transpose(1, 2))

    FCo = undiag(FCoD)

    # ---------------- posterior ---------------------------------------------
    pair_ok = (a_ >= 1) & (b_ > a_) & (b_ <= nbb) & allow_pair
    fci = torch.cat([FC[:, :, :1], FC[:, :, :-1]], dim=2)      # FC[a, b-1]
    fcov = torch.cat([FCo[:, :, :1], FCo[:, :, :-1]], dim=2)
    logp = fci + fcov - Z[:, None, None]
    post = torch.where(pair_ok & (logp > -60.0), torch.exp(torch.clamp(logp, max=0.0)), 0.0)
    return torch.clamp(post, 0.0, 1.0)


def _prep_one(seq: str, n: int, L: int):
    """Host prep of one sequence's codes and pair and unpaired masks (no
    structure constraint: the check folds none)."""
    s = np.full(L + 2, 4, dtype=np.int32)
    s[1 : n + 1] = CF.encode(seq)

    allow_pair = CF.COMPLEMENTARY[s[:, None], s[None, :]].copy()
    ii = np.arange(L + 2)
    allow_pair &= ii[None, :] > ii[:, None]
    allow_pair &= (ii[:, None] >= 1) & (ii[None, :] <= n)
    allow_unpaired_pos = np.ones(L + 2, dtype=bool)
    return s, allow_pair, allow_unpaired_pos


def batch_bp_posteriors(seqs, th, device):
    """Dense (n, n) float32 numpy pair posteriors per sequence (upper
    triangle), entries kept only when strictly greater than `th`: one
    batched run per 32-length bucket on `device` (src/fold.cpp:174-207
    adapter, applied per sequence)."""
    if not seqs:
        return []
    dev = torch.device(device)
    tab = tables(dev)
    out: list = [None] * len(seqs)
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        buckets.setdefault(_round_up(len(s), 32), []).append(i)
    for L, idxs in buckets.items():
        preps = [_prep_one(seqs[i], len(seqs[i]), L) for i in idxs]
        as_t = lambda a: torch.from_numpy(np.stack(a)).to(dev)  # noqa: E731
        posts = inside_outside(
            as_t([p[0] for p in preps]), as_t([p[1] for p in preps]),
            as_t([p[2] for p in preps]),
            torch.tensor([len(seqs[i]) for i in idxs], device=dev), tab,
        ).cpu().numpy()
        for b, i in enumerate(idxs):
            n = len(seqs[i])
            pm = posts[b, 1 : n + 1, 1 : n + 1].astype(np.float32)
            pm[pm <= th] = 0.0
            out[i] = pm
    return out
