"""Batched CONTRAlign 5-state pair-CRF (contralign/InferenceEngine.ipp).

Port of `dafs_tpu/ops/paircrf.py`: ComputeForward (:999-1071),
ComputeBackward (:1079-1150) and ComputePosterior (:1280-1317) as
anti-diagonal wavefronts over a batch of sequence pairs, with the same
Fast_LogPlusEquals / Fast_Exp approximations and the same per-cell
accumulation order.  Like `ops/pairhmm.py`'s plain versions, each pass is a
Python loop over the diagonals with the cells of one diagonal (for every
pair of the batch) as a vector; every tensor lives on the caller's device.
This is plain PyTorch on every device: `dafs_tpu` writes this model in XLA
code, not as a Pallas kernel.

States: 0=MATCH, 1=INS_X, 2=INS_Y, 3=INS2_X, 4=INS2_Y.  Double-affine gaps:
two insert tiers sharing emissions but with separate bias/transition
weights; INS_X receives {M, IX, IY}, INS2_X receives {M, I2X, I2Y} (no tier
mixing).  The pair-transition term is dropped at the first cell of each
state: (1,1) for MATCH, (1,0) for the X inserts, (0,1) for the Y inserts.
"""

from __future__ import annotations

import numpy as np
import torch

from dafs_tpu_torch import params
from dafs_tpu_torch.models import contralign_params as CP
from dafs_tpu_torch.ops.logspace import NEG_INF as NEG
from dafs_tpu_torch.ops.logspace import contra_fast_exp
from dafs_tpu_torch.ops.logspace import contra_fast_logplus as lse

M_, IX, IY, I2X, I2Y = range(5)


def _round_up(n, m):
    return -(-n // m) * m


def tables(device) -> dict[str, torch.Tensor]:
    """CONTRAlign tables on `device`: match (5, 5), ins (5,), single (5,),
    pair (5, 5)."""
    return params.to_device(CP.tables(), device)


def _shift_right(x, fill):
    """x[..., i] -> x[..., i-1], filling index 0."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def _shift_left(x, fill):
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], dim=-1)


def _gate(cond):
    """1.0 where `cond` is false, 0.0 where true: the pair-term gate."""
    return torch.where(cond, 0.0, 1.0)


def forward_backward_posterior(codes1, len1, codes2, len2, tab):
    """Match posteriors (B, l1max, l2max) for a batch of pairs.

    codes1 (B, l1max+1), codes2 (B, l2max+1): int 1-based codes (index 0 and
    the padding hold 4, the unknown base); len1, len2 (B,) true lengths."""
    B, imax = codes1.shape
    l1max, l2max = imax - 1, codes2.shape[1] - 1
    ndiag = l1max + l2max + 1
    dev = codes1.device
    match_t, ins_t, single, pair = tab["match"], tab["ins"], tab["single"], tab["pair"]
    codes1, codes2 = codes1.long(), codes2.long()
    len1b, len2b = len1.long()[:, None], len2.long()[:, None]
    i_idx = torch.arange(imax, device=dev)[None, :]

    def emissions(d):
        """ScoreMatch emission (match[x_i][y_j] + single[MATCH]) and the
        insert-Y emission ins[y_j] on diagonal d, j clipped to [0, l2max];
        0.0 beyond the last diagonal."""
        if d >= ndiag:
            z = torch.zeros((B, imax), dtype=torch.float32, device=dev)
            return z, z
        c2 = codes2[:, (d - i_idx[0]).clamp(0, l2max)]
        return match_t[codes1, c2] + single[M_], ins_t[c2]

    EX = ins_t[codes1]  # ins[x_i], (B, imax)

    def em(e, state, src, dst):
        """X-insert emission `e` (ins[x_i] or ins[x_{i+1}]) plus the state's
        bias and the transition src -> dst, the two table constants added
        first.  `dafs_tpu` writes `(e + bias) + transition`; XLA folds that
        into `e + (bias + transition)` for these emissions, which are the
        same on every diagonal, but not for the Y emissions, which it reads
        per diagonal, nor where the transition is gated.  The port adds in
        the order XLA runs, and then equals `dafs_tpu` bit for bit on the
        CPU (no FMA contraction)."""
        return e + (single[state] + pair[src, dst])

    neg = torch.full((B, 5, imax), NEG, dtype=torch.float32, device=dev)

    # ---- forward ----------------------------------------------------------
    fdiags = []
    prev = prev2 = neg  # diagonals d-1, d-2
    for d in range(ndiag):
        me_d, ey_d = emissions(d)
        j_idx = d - i_idx
        valid = (i_idx <= len1b) & (j_idx >= 0) & (j_idx <= len2b)
        not_first = (i_idx > 1) | (j_idx > 1)

        # MATCH from (i-1, j-1): sources in order M, IX, IY, I2X, I2Y
        # (InferenceEngine.ipp:1031-1038); pair term dropped at (1,1)
        pM, pIX, pIY, pI2X, pI2Y = (_shift_right(prev2[:, k], NEG) for k in range(5))
        pr = _gate((i_idx == 1) & (j_idx == 1))
        m_new = pM + (me_d + pr * pair[M_, M_])
        for src, k in ((pIX, IX), (pIY, IY), (pI2X, I2X), (pI2Y, I2Y)):
            m_new = torch.where(not_first, lse(m_new, src + (me_d + pair[k, M_])), m_new)
        m_new = torch.where(valid & (i_idx > 0) & (j_idx > 0), m_new, NEG)

        # INS_X from (i-1, j): sources M, IX, IY (:1042-1045); the boundary
        # column j == 0 chains IX only (:1015); pair dropped at (1,0)
        qM, qIX, qIY, qI2X, qI2Y = (_shift_right(prev[:, k], NEG) for k in range(5))
        prx = _gate((i_idx == 1) & (j_idx == 0))
        j_pos = j_idx > 0
        x_ok = valid & (i_idx > 0)
        ex1 = EX + single[IX]
        x_new = torch.where(
            j_pos,
            lse(lse(qM + em(EX, IX, M_, IX), qIX + em(EX, IX, IX, IX)),
                qIY + em(EX, IX, IY, IX)),
            qIX + (ex1 + prx * pair[IX, IX]),
        )
        x_new = torch.where(x_ok, x_new, NEG)
        ex2 = EX + single[I2X]
        x2_new = torch.where(
            j_pos,
            lse(lse(qM + em(EX, I2X, M_, I2X), qI2X + em(EX, I2X, I2X, I2X)),
                qI2Y + em(EX, I2X, I2Y, I2X)),
            qI2X + (ex2 + prx * pair[I2X, I2X]),
        )
        x2_new = torch.where(x_ok, x2_new, NEG)

        # INS_Y from (i, j-1): sources M, IX, IY (:1048-1050); the boundary
        # row i == 0 chains IY only (:1016); pair dropped at (0,1)
        pry = _gate((i_idx == 0) & (j_idx == 1))
        i_pos = i_idx > 0
        y_ok = valid & (j_idx > 0)
        ey1 = ey_d + single[IY]
        y_new = torch.where(
            i_pos,
            lse(lse(prev[:, M_] + (ey1 + pair[M_, IY]), prev[:, IX] + (ey1 + pair[IX, IY])),
                prev[:, IY] + (ey1 + pair[IY, IY])),
            prev[:, IY] + (ey1 + pry * pair[IY, IY]),
        )
        y_new = torch.where(y_ok, y_new, NEG)
        ey2 = ey_d + single[I2Y]
        y2_new = torch.where(
            i_pos,
            lse(lse(prev[:, M_] + (ey2 + pair[M_, I2Y]), prev[:, I2X] + (ey2 + pair[I2X, I2Y])),
                prev[:, I2Y] + (ey2 + pair[I2Y, I2Y])),
            prev[:, I2Y] + (ey2 + pry * pair[I2Y, I2Y]),
        )
        y2_new = torch.where(y_ok, y2_new, NEG)

        diag = torch.stack([m_new, x_new, y_new, x2_new, y2_new], dim=1)
        # origin cell (0,0): all states 0
        diag = torch.where(((i_idx == 0) & (j_idx == 0))[:, None, :], 0.0, diag)
        diag = torch.where(valid[:, None, :], diag, NEG)
        fdiags.append(diag)
        prev, prev2 = diag, prev
    fdiags = torch.stack(fdiags)  # (ndiag, B, 5, imax)

    # ---- backward ---------------------------------------------------------
    # cell (a, b) receives
    #   match (a+1, b+1):      into all k (k != M needs a+1>1 or b+1>1)
    #   insX/ins2X (a+1, b):   into {M, IX, IY} / {M, I2X, I2Y} if b >= 1,
    #                          else into {IX} / {I2X}
    #   insY/ins2Y (a, b+1):   the same with a >= 1
    # LOG_ADD order per target (the C++ loop order):
    #   M:   match, insX, ins2X, insY, ins2Y
    #   IX:  match, insX, insY          IY:  match, insX, insY
    #   I2X: match, ins2X, ins2Y        I2Y: match, ins2X, ins2Y
    EX_next = _shift_left(EX, 0.0)  # ins[x_{i+1}]
    ex1n, ex2n = EX_next + single[IX], EX_next + single[I2X]
    bdiags = [None] * ndiag
    nxt = nxt2 = neg
    for d in range(ndiag - 1, -1, -1):
        me_n2, _ = emissions(d + 2)
        _, ey_n1 = emissions(d + 1)
        j_idx = d - i_idx
        valid = (i_idx <= len1b) & (j_idx >= 0) & (j_idx <= len2b)

        me_n = _shift_left(me_n2, 0.0)  # ScoreMatch emission at (i+1, j+1)
        bM11 = _shift_left(nxt2[:, M_], NEG)
        # the successors (i+1, j+1), (i+1, j), (i, j+1) are the gated first
        # cells (1,1), (1,0), (0,1) exactly when (i, j) == (0, 0)
        g00 = _gate((i_idx == 0) & (j_idx == 0))
        has_m = (i_idx < len1b) & (j_idx < len2b)
        has_m_nf = has_m & ((i_idx + 1 > 1) | (j_idx + 1 > 1))

        bIX1 = _shift_left(nxt[:, IX], NEG)  # Fb[IX][i+1, j]
        bI2X1 = _shift_left(nxt[:, I2X], NEG)
        bIY1 = nxt[:, IY]                    # Fb[IY][i, j+1]
        bI2Y1 = nxt[:, I2Y]
        has_x = i_idx < len1b
        has_y = j_idx < len2b
        ey1n, ey2n = ey_n1 + single[IY], ey_n1 + single[I2Y]
        x_in = has_x & (j_idx != 0)
        y_in = has_y & (i_idx != 0)

        def lpe(x, y, cond):
            return torch.where(cond, lse(x, y), x)

        nb = neg[:, 0]
        mterm = bM11 + me_n
        bM = lpe(nb, mterm + g00 * pair[M_, M_], has_m)
        bIX = lpe(nb, mterm + pair[IX, M_], has_m_nf)
        bIY = lpe(nb, mterm + pair[IY, M_], has_m_nf)
        bI2X = lpe(nb, mterm + pair[I2X, M_], has_m_nf)
        bI2Y = lpe(nb, mterm + pair[I2Y, M_], has_m_nf)
        # from insX (i+1, j)
        bM = lpe(bM, bIX1 + em(EX_next, IX, M_, IX), x_in)
        bIX = lpe(bIX, bIX1 + (ex1n + g00 * pair[IX, IX]), has_x)
        bIY = lpe(bIY, bIX1 + em(EX_next, IX, IY, IX), x_in)
        # from ins2X (i+1, j)
        bM = lpe(bM, bI2X1 + em(EX_next, I2X, M_, I2X), x_in)
        bI2X = lpe(bI2X, bI2X1 + (ex2n + g00 * pair[I2X, I2X]), has_x)
        bI2Y = lpe(bI2Y, bI2X1 + em(EX_next, I2X, I2Y, I2X), x_in)
        # from insY (i, j+1)
        bM = lpe(bM, bIY1 + (ey1n + pair[M_, IY]), y_in)
        bIX = lpe(bIX, bIY1 + (ey1n + pair[IX, IY]), y_in)
        bIY = lpe(bIY, bIY1 + (ey1n + g00 * pair[IY, IY]), has_y)
        # from ins2Y (i, j+1)
        bM = lpe(bM, bI2Y1 + (ey2n + pair[M_, I2Y]), y_in)
        bI2X = lpe(bI2X, bI2Y1 + (ey2n + pair[I2X, I2Y]), y_in)
        bI2Y = lpe(bI2Y, bI2Y1 + (ey2n + g00 * pair[I2Y, I2Y]), has_y)

        diag = torch.stack([bM, bIX, bIY, bI2X, bI2Y], dim=1)
        at_end = (i_idx == len1b) & (j_idx == len2b)
        diag = torch.where(at_end[:, None, :], 0.0, diag)
        diag = torch.where(valid[:, None, :], diag, NEG)
        bdiags[d] = diag
        nxt, nxt2 = diag, nxt
    bdiags = torch.stack(bdiags)

    # ---- posterior --------------------------------------------------------
    # Z = log-sum over the states at (len1, len2), k in order 0..4 (:1252-1257)
    b_ar = torch.arange(B, device=dev)
    f_end = fdiags[len1.long() + len2.long(), b_ar, :, len1.long()]  # (B, 5)
    Z = f_end[:, 0]
    for k in range(1, 5):
        Z = lse(Z, f_end[:, k])

    # posterior[i][j] = sum over k of Fast_Exp(Ff[k][i-1, j-1]
    #                   + ScoreMatch(i, j, k) + Fb[MATCH][i, j] - Z)  (:1280-1307)
    ii = torch.arange(1, l1max + 1, device=dev)[:, None]
    jj = torch.arange(1, l2max + 1, device=dev)[None, :]
    dsel = ii + jj
    f_cells = fdiags[dsel - 2, :, :, ii - 1].permute(2, 3, 0, 1)  # (B, 5, l1max, l2max)
    b_match = bdiags[dsel, :, M_, ii].permute(2, 0, 1)           # (B, l1max, l2max)
    c2 = codes2[:, 1:]
    me_cells = match_t[codes1[:, 1:, None], c2[:, None, :]] + single[M_]
    prm = _gate((ii == 1) & (jj == 1))
    not_first = (ii > 1) | (jj > 1)
    logZ = Z[:, None, None]
    post = torch.zeros((B, l1max, l2max), dtype=torch.float32, device=dev)
    for k in range(5):
        sc = me_cells + (prm * pair[k, M_])[None]
        term = contra_fast_exp(f_cells[:, k] + sc + b_match - logZ)
        if k != M_:
            term = torch.where(not_first[None], term, 0.0)
        post = post + term
    post = torch.clamp(post, 0.0, 1.0)
    valid = (ii[None] <= len1b[:, :, None]) & (jj[None] <= len2b[:, :, None])
    return torch.where(valid, post, 0.0)


def encode_batch(seqs, lmax):
    """(B, lmax+1) int32 codes, index 0 and the padding 4, and (B,) lengths."""
    codes = np.full((len(seqs), lmax + 1), 4, dtype=np.int32)
    for b, s in enumerate(seqs):
        codes[b, 1 : len(s) + 1] = CP.encode(s)
    return codes, np.array([len(s) for s in seqs], dtype=np.int32)


def batch_posteriors(seqs1, seqs2, threshold, device):
    """Dense (L1, L2) float32 numpy match posteriors per pair, entries kept
    only when strictly greater than `threshold`; all pairs in one padded
    batch on `device`."""
    if not seqs1:
        return []
    l1max = _round_up(max(len(s) for s in seqs1), 32)
    l2max = _round_up(max(len(s) for s in seqs2), 32)
    codes1, len1 = encode_batch(seqs1, l1max)
    codes2, len2 = encode_batch(seqs2, l2max)
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    post = forward_backward_posterior(
        as_t(codes1), as_t(len1), as_t(codes2), as_t(len2), tables(dev)
    ).cpu().numpy()
    out = []
    for b in range(len(seqs1)):
        p = post[b, : len1[b], : len2[b]].copy()
        p[p <= threshold] = 0.0
        out.append(p)
    return out
