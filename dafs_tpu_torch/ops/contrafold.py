"""CONTRAfold v2 inside-outside (contrafold/InferenceEngine.ipp).

Port of `dafs_tpu/ops/contrafold.py`: ComputeInside (:3356-3722),
ComputeOutside (:3731-4490) and ComputePosterior (:4498+) for the DAFS
configuration (helix-length and isolated-pair features off, max_bp_dist=0,
complementary pairs only).  The sequences of one 32-length bucket run as
one batch on `device`.  `inside_outside` is plain PyTorch, some 35 k small
kernels a bucket of L 96, one diagonal at a time.  On a card each bucket
replays it as one CUDA graph (`_Graph`), captured once a shape: the same
kernels with the same launch configurations, so the posteriors are those
of the eager run bit for bit, without the Python of every launch.  A CPU
tensor runs it eagerly.

Each bucket runs in the span `contrafold.batch` (attributes `B`, `Bp`,
`L`; counters `steps`, `cells`, `graph_captures` and `graph_replays`, see
`batch_bp_posteriors`), with its read-back in `contrafold.readback` under
it.

Layout, as in `dafs_tpu`: log-domain tables FC/FM/FM1 over (L+2)^2 cells,
filled one diagonal (span d = j - i) per step, with diagonal-major shadows
D[e, a] = M[a, a+e] so that a step reads whole rows.  FC(i, j) is the score
of the region closed by the pair (i, j+1).  Per step:

- the single-branch loops (stacks, bulges, interior loops) as a bounded
  31x31 stencil over the split sizes (l1, l2), l1 + l2 <= MAXS = 30, read
  from the shadows by one gather per table;
- the multiloop split FM2(i, j) = sum over k of FM1(i, k) FM(k, j), a masked
  reduction over a row-major window;
- the outside pass keeps the O(L^3) FM2 adjoints in two running
  accumulators (A_FM1, A_FM) instead of the reference's rolling pointers.

The pair posterior is exp(FCi + FCo - Z) at the pair's FC cell, gated at
-60 and clipped to [0, 1]: every pair production routes through FC with the
pair's own scores applied by the producing context, so this equals the
reference's per-production sum.

Deviation kept from `dafs_tpu`: the reductions are exact log-sum-exp (the
reference uses its piecewise-cubic Fast_LogPlusEquals; ~1e-5 in log space),
guarded for the -2e20 sentinel.  `torch.log1p`/`exp` and XLA's differ in the
last bits, so the posteriors agree with `dafs_tpu` to a tolerance, not bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from dafs_tpu_torch import params
from dafs_tpu_torch.ops import contrafold_params as CF
from dafs_tpu_torch.utils import spans

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


_TABLES: dict = {}  # device -> its tables, uploaded once (a captured graph reads their addresses)


def tables(device) -> dict[str, torch.Tensor]:
    """CONTRAfold v2 tables on `device` (`contrafold_params.tables()`), the
    five loop weights as 0-dim tensors; one upload a device, the same
    tensors for every later call."""
    dev = torch.device(device)
    if dev not in _TABLES:
        _TABLES[dev] = params.to_device(CF.tables(), dev)
    return _TABLES[dev]


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
    # the zero as a tensor on the batch's device: a CUDA graph's capture
    # cannot copy a host scalar
    F5o[b_ar, n.long()] = torch.zeros((), device=dev)
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


def _prep_one(seq: str, n: int, L: int, constraint: str | None):
    """Host prep of one sequence's codes and constraint masks
    (`dafs_tpu/ops/contrafold.py` `_prep_one`)."""
    s = np.full(L + 2, 4, dtype=np.int32)
    s[1 : n + 1] = CF.encode(seq)

    allow_pair = CF.COMPLEMENTARY[s[:, None], s[None, :]].copy()
    ii = np.arange(L + 2)
    allow_pair &= ii[None, :] > ii[:, None]
    allow_pair &= (ii[:, None] >= 1) & (ii[None, :] <= n)
    allow_unpaired_pos = np.ones(L + 2, dtype=bool)

    if constraint is not None:
        # SetConstraint/UseConstraints: '(' ')' matched = forced pair, kept
        # only where it was allowed already; '.' = forced unpaired (forbids
        # its pairs, may stay unpaired); '?' = free
        if len(constraint) != n:
            raise ValueError("constraint length differs from the sequence length")
        stack = []
        for k, ch in enumerate(constraint):
            pos = k + 1
            if ch == ".":
                allow_unpaired_pos[pos] = True
                allow_pair[pos, :] = False
                allow_pair[:, pos] = False
            elif ch == "(":
                stack.append(pos)
            elif ch == ")":
                a = stack.pop()
                keep = allow_pair[a, pos]
                allow_pair[a, :] = False
                allow_pair[:, a] = False
                allow_pair[pos, :] = False
                allow_pair[:, pos] = False
                allow_pair[a, pos] = keep
                allow_unpaired_pos[a] = False
                allow_unpaired_pos[pos] = False
    return s, allow_pair, allow_unpaired_pos


def _bucket_arrays(seqs, constraints, L: int, rows: int):
    """Host inputs of `inside_outside` for one bucket: the codes, pair and
    unpaired masks and lengths of `seqs`, then `rows - len(seqs)` copies of
    the first sequence's, whose posteriors the caller drops."""
    preps = [_prep_one(s, len(s), L, c) for s, c in zip(seqs, constraints)]
    lens = [len(s) for s in seqs]
    pad = rows - len(seqs)
    preps += [preps[0]] * pad
    lens += lens[:1] * pad
    return (*(np.stack([p[k] for p in preps]) for k in range(3)),
            np.array(lens, dtype=np.int64))


def _graph_rows(B: int, L: int) -> int:
    """Rows of the graph that a bucket of B sequences at L replays: B below
    4; from 16 on, the next power of two; between, 15 where a row (L + 2)
    is shorter than 512, else B rounded up within its power-of-two class
    (4-7 to 7, 8-15 to 15).

    The padding must leave every sum of `inside_outside` in the order of
    the unpadded batch's, so that a bucket's posteriors are the eager run's
    bit for bit.  PyTorch's CUDA reduction (`ATen/native/cuda/Reduce.cuh`,
    `set_block_dimension`) spreads a sum along each of R rows over
    min(512 / min(last_pow2(R), 16), P) threads, P the power of two at or
    below the row's loads (its length, a quarter of it from 128 on).  F5's
    sums over B rows of L + 2 have P <= 64 below 512, so every B under 16
    sums alike, as every B from 16 on does; at 512 and above only a class
    does.  The multiloop sums over B (L + 2 - d) rows reach 16 rows at
    every diagonal d that holds a cell once B >= 4, and the stencil sums,
    down the rows, do not depend on B past 1.  Rounded up to 16 instead, B
    3, 6 and 8 at L 96 and B 5 to 15 at L 320 moved posteriors by up to
    7e-7 on an H100, and a lone sequence moves in any larger batch (L 32,
    320).
    """
    if B < 4:
        return B
    if B >= 16:
        return 1 << (B - 1).bit_length()
    if L + 2 < 512:
        return 15
    return (1 << B.bit_length()) - 1


_CAPTURE: dict = {}  # card -> (the memory pool and the stream of its CONTRAfold captures)


class _Graph:
    """`inside_outside` captured as one CUDA graph at (rows, L) on one card:
    static inputs that each run fills with one copy each, and the static
    posteriors that each replay writes.  A card's CONTRAfold graphs are
    captured on one stream into one memory pool; they replay one at a time
    on the current stream, and each run's posteriors are read back before
    the next."""

    def __init__(self, dev, rows: int, L: int, tab):
        A = L + 2
        with torch.cuda.device(dev):
            self.inputs = (torch.empty((rows, A), dtype=torch.int32, device=dev),
                           torch.empty((rows, A, A), dtype=torch.bool, device=dev),
                           torch.empty((rows, A), dtype=torch.bool, device=dev),
                           torch.empty(rows, dtype=torch.int64, device=dev))
            self.tab = tab  # the graph reads these tensors' addresses
            if dev not in _CAPTURE:
                _CAPTURE[dev] = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
            pool, stream = _CAPTURE[dev]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.post = inside_outside(*self.inputs, tab)

    def run(self, arrays) -> torch.Tensor:
        """Posteriors (rows, L+2, L+2) of the host arrays `arrays` (as
        `_bucket_arrays` gives them), valid until the next run."""
        for x, a in zip(self.inputs, arrays):
            x.copy_(torch.from_numpy(a))
        with torch.cuda.device(self.post.device):
            self.graph.replay()
        return self.post


_GRAPHS: dict = {}  # (device, rows, L) -> _Graph


def bp_posterior(seq: str, th: float, device="cuda", constraint: str | None = None) -> np.ndarray:
    """One sequence's (n, n) upper-triangular pair posteriors, entries kept
    > th (`dafs_tpu/ops/contrafold.py:572`)."""
    return batch_bp_posteriors([seq], th, device, constraints=[constraint])[0]


def batch_bp_posteriors(seqs, th, device, constraints=None):
    """Dense (n, n) float32 numpy pair posteriors per sequence (upper
    triangle), entries kept only when strictly greater than `th`: one
    batched run per 32-length bucket on `device` (src/fold.cpp:174-207
    adapter, applied per sequence).  On a card a bucket of B sequences
    replays the graph of (`_graph_rows(B, L)`, L), captured at its first
    bucket; on the CPU it runs `inside_outside` eagerly on its B rows.

    Each bucket is recorded as the span `contrafold.batch` (attributes `B`,
    `Bp`, the rows it ran, and `L`) with the counters `steps`, the loop
    steps of the inside, the exterior (F5 and its outside) and the outside
    pass, 4 L; `cells`, the cells (i, j), 1 <= i <= j <= n, of each
    sequence's true length n, summed over the bucket: one table's cells
    (the inside fills FC, FM and FM1 over them, the outside their outside
    values), padding left out; `graph_captures`, 1 where this bucket
    captured its graph; and `graph_replays`, 1 where it ran as a replay (0
    on the CPU)."""
    if not seqs:
        return []
    dev = torch.device(device)
    card = dev.type == "cuda"
    if card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    tab = tables(dev)
    out: list = [None] * len(seqs)
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        buckets.setdefault(_round_up(len(s), 32), []).append(i)
    for L, idxs in buckets.items():
        B = len(idxs)
        rows = _graph_rows(B, L) if card else B
        arrays = _bucket_arrays(
            [seqs[i] for i in idxs],
            [constraints[i] if constraints is not None else None for i in idxs], L, rows)
        with spans.span("contrafold.batch", B=B, Bp=rows, L=L):
            captured = False
            if card:
                graph = _GRAPHS.get((dev, rows, L))
                if graph is None:
                    graph = _GRAPHS[dev, rows, L] = _Graph(dev, rows, L, tab)
                    captured = True
                posts = graph.run(arrays)
            else:
                posts = inside_outside(*map(torch.from_numpy, arrays), tab)
            with spans.span("contrafold.readback"):
                posts = posts[:B].cpu().numpy()
            if spans.recording():
                spans.count("steps", 4 * L)
                spans.count("cells", sum(len(seqs[i]) * (len(seqs[i]) + 1) // 2 for i in idxs))
                spans.count("graph_captures", int(captured))
                spans.count("graph_replays", int(card))
        for b, i in enumerate(idxs):
            n = len(seqs[i])
            pm = posts[b, 1 : n + 1, 1 : n + 1].astype(np.float32)
            pm[pm <= th] = 0.0
            out[i] = pm
    return out
