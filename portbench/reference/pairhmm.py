"""Batched ProbCons pair-HMM forward/backward/posterior.

Port of `dafs_tpu/ops/pairhmm.py` (probconsRNA/ProbabilisticModel.h:105-259,
337-403).  The forward and backward passes are anti-diagonal wavefronts over
a batch of sequence pairs; each cell evaluates the same float32 expression
tree as the reference (same LOG_ADD approximation, same accumulation order).

On a CUDA tensor every step from the base codes to the masked posteriors
runs in the hand-written kernels of `pairhmm_cuda`: K1 (forward) and K2
(backward) side by side on two streams, then the posterior kernel (the
totals from the captures, `probcons_exp(min(0, fm + bm - total))`, the mask
to the true lengths); `forward_backward_posterior` launches those three and
nothing else on the device.  On a CPU tensor the same steps run as the plain
versions below: the recurrences as a Python loop over diagonals with the
cells of one diagonal as a vector, and `posterior` in plain PyTorch.  The
threshold step and the assembly of `batch_posteriors` stay on the host.

Pass contract (both versions): codes1 (B, l1max+1) and codes2 (B, l2max+1)
int32 1-based base codes (index 0 unused), len1/len2 (B,) int32.  forward
returns fm (B, l1max+1, l2max+1), the forward M value of every cell, and
fcap (B, 6) = [f_M, f_X, f_Y at (len1, len2), f_M(1,1), f_X(1,0), f_Y(0,1)];
backward returns bm like fm and bcap (B, 3) = [b_M(1,1), b_X(1,0),
b_Y(0,1)].

State order: 0=M, 1=Ix (gap in seq2), 2=Iy (gap in seq1).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import params
from portbench.reference import probcons_params as P
from portbench.reference.logspace import LOG_ZERO, log_add, probcons_exp


def _round_up(n, m):
    return -(-n // m) * m


def tables(device) -> dict[str, torch.Tensor]:
    """ProbCons log-domain tables on `device` (init (3,), trans (3, 3),
    match (7, 7), ins (7,)), built exactly as ProbabilisticModel.h:55-88."""
    return params.to_device(P.log_tables(), device)


def _emission_codes(codes2, d, imax):
    """w[b, i] = codes2[b, d - i], and code 0 where d - i is outside
    [0, l2max] (consumers mask those cells)."""
    l2max = codes2.shape[1] - 1
    j = d - torch.arange(imax, device=codes2.device)
    ok = (j >= 0) & (j <= l2max)
    w = codes2[:, j.clamp(0, l2max)]
    return torch.where(ok[None, :], w, torch.zeros_like(w))


def _shift_right(x, fill):
    """x[..., i] -> x[..., i-1], filling index 0."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def _shift_left(x, fill):
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], dim=-1)


def _scatter_diag(out, vals, d):
    """out[:, i, d - i] = vals[:, i] for the cells of diagonal d that lie in
    the (imax, l2max + 1) grid."""
    imax, W = out.shape[1], out.shape[2]
    i = torch.arange(imax, device=out.device)
    j = d - i
    ok = (j >= 0) & (j < W)
    out[:, i[ok], j[ok]] = vals[:, ok]


def forward_plain(codes1, len1, codes2, len2, tab):
    """Plain version of kernel K1 (`pairhmm_cuda.forward`)."""
    B, imax = codes1.shape
    l2max = codes2.shape[1] - 1
    ndiag = imax + l2max
    dev = codes1.device
    t = tab["trans"]
    t00, t10, t20 = t[0, 0], t[1, 0], t[2, 0]
    t01, t11, t02, t22 = t[0, 1], t[1, 1], t[0, 2], t[2, 2]
    init = tab["init"]
    i_idx = torch.arange(imax, device=dev)[None, :]
    len1b = len1[:, None]
    len2b = len2[:, None]
    codes1 = codes1.long()
    codes2 = codes2.long()
    ins1 = tab["ins"][codes1]

    fm = torch.empty((B, imax, l2max + 1), dtype=torch.float32, device=dev)
    fcap = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    lz = torch.full((B, imax), LOG_ZERO, dtype=torch.float32, device=dev)
    pm0, px0, py0 = lz, lz, lz  # diagonal d-1
    mm, mx, my = lz, lz, lz     # diagonal d-2
    i_end = len1.long().clamp(max=imax - 1)[:, None]
    for d in range(ndiag):
        w = _emission_codes(codes2, d, imax)
        m_d = tab["match"][codes1, w]
        e2_d = tab["ins"][w]
        j_idx = d - i_idx
        valid = (i_idx <= len1b) & (j_idx >= 0) & (j_idx <= len2b)
        not_init = (i_idx > 1) | (j_idx > 1)

        acc = _shift_right(mm, LOG_ZERO) + t00
        acc = log_add(acc, _shift_right(mx, LOG_ZERO) + t10)
        acc = log_add(acc, _shift_right(my, LOG_ZERO) + t20)
        m_new = acc + m_d
        m_new = torch.where(valid & not_init & (i_idx > 0) & (j_idx > 0), m_new, LOG_ZERO)

        pm = _shift_right(pm0, LOG_ZERO)
        px = _shift_right(px0, LOG_ZERO)
        x_new = ins1 + log_add(pm + t01, px + t11)
        x_new = torch.where(valid & not_init & (i_idx > 0), x_new, LOG_ZERO)

        y_new = e2_d + log_add(pm0 + t02, py0 + t22)
        y_new = torch.where(valid & not_init & (j_idx > 0), y_new, LOG_ZERO)

        # init cells (ProbabilisticModel.h:122-131)
        m_new = torch.where((i_idx == 1) & (j_idx == 1), init[0] + m_d, m_new)
        x_new = torch.where((i_idx == 1) & (j_idx == 0) & (1 <= len1b), init[1] + ins1, x_new)
        y_new = torch.where((i_idx == 0) & (j_idx == 1) & (1 <= len2b), init[2] + e2_d, y_new)
        m_new = torch.where(valid & (i_idx > 0) & (j_idx > 0), m_new, LOG_ZERO)

        _scatter_diag(fm, m_new, d)
        # captures for ComputeTotalProbability
        end = len1 + len2 == d
        for c, v in enumerate((m_new, x_new, y_new)):
            fcap[:, c] = torch.where(end, v.gather(1, i_end)[:, 0], fcap[:, c])
        if d == 2 and imax > 1:
            fcap[:, 3] = m_new[:, 1]
        if d == 1:
            if imax > 1:
                fcap[:, 4] = x_new[:, 1]
            fcap[:, 5] = y_new[:, 0]

        mm, mx, my = pm0, px0, py0
        pm0, px0, py0 = m_new, x_new, y_new
    return fm, fcap


def backward_plain(codes1, len1, codes2, len2, tab):
    """Plain version of kernel K2 (`pairhmm_cuda.backward`)."""
    B, imax = codes1.shape
    l2max = codes2.shape[1] - 1
    ndiag = imax + l2max
    dev = codes1.device
    t = tab["trans"]
    init = tab["init"]
    i_idx = torch.arange(imax, device=dev)[None, :]
    len1b = len1[:, None]
    len2b = len2[:, None]
    codes1 = codes1.long()
    codes2 = codes2.long()
    ins1_next = _shift_left(tab["ins"][codes1], 0.0)

    bm = torch.empty((B, imax, l2max + 1), dtype=torch.float32, device=dev)
    bcap = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    lz = torch.full((B, imax), LOG_ZERO, dtype=torch.float32, device=dev)
    nm0, nx0, ny0 = lz, lz, lz  # diagonal d+1
    nm2 = lz                    # diagonal d+2 (M only is read)
    for d in range(ndiag - 1, -1, -1):
        m_n2 = tab["match"][codes1, _emission_codes(codes2, d + 2, imax)]
        e2_n = tab["ins"][_emission_codes(codes2, d + 1, imax)]
        j_idx = d - i_idx
        valid = (i_idx <= len1b) & (j_idx >= 0) & (j_idx <= len2b)

        match_n = _shift_left(m_n2, 0.0)  # match(c1[i+1], c2[j+1])
        has_m = (i_idx < len1b) & (j_idx < len2b) & valid
        has_x = (i_idx < len1b) & valid
        has_y = (j_idx < len2b) & valid

        bm_11 = _shift_left(nm2, LOG_ZERO)
        bx_n = _shift_left(nx0, LOG_ZERO)
        by_n = ny0
        prob_xy = bm_11 + match_n

        def lpe(x, y, cond):
            return torch.where(cond, log_add(x, y), x)

        # order matches ProbabilisticModel.h:233-249
        bM = lpe(lz, prob_xy + t[0, 0], has_m)
        bX = lpe(lz, prob_xy + t[1, 0], has_m)
        bY = lpe(lz, prob_xy + t[2, 0], has_m)
        bM = lpe(bM, bx_n + ins1_next + t[0, 1], has_x)
        bX = lpe(bX, bx_n + ins1_next + t[1, 1], has_x)
        bM = lpe(bM, by_n + e2_n + t[0, 2], has_y)
        bY = lpe(bY, by_n + e2_n + t[2, 2], has_y)

        at_end = (i_idx == len1b) & (j_idx == len2b)
        bM = torch.where(at_end, init[0], bM)
        bX = torch.where(at_end, init[1], bX)
        bY = torch.where(at_end, init[2], bY)
        bM = torch.where(valid, bM, LOG_ZERO)
        bX = torch.where(valid, bX, LOG_ZERO)
        bY = torch.where(valid, bY, LOG_ZERO)

        _scatter_diag(bm, bM, d)
        if d == 2 and imax > 1:
            bcap[:, 0] = bM[:, 1]
        if d == 1:
            if imax > 1:
                bcap[:, 1] = bX[:, 1]
            bcap[:, 2] = bY[:, 0]

        nm2 = nm0
        nm0, nx0, ny0 = bM, bX, bY
    return bm, bcap


def forward(codes1, len1, codes2, len2, tab):
    """Forward pass: kernel K1 on a CUDA tensor, the plain version on CPU."""
    return forward_plain(codes1, len1, codes2, len2, tab)


def backward(codes1, len1, codes2, len2, tab):
    """Backward pass: kernel K2 on a CUDA tensor, the plain version on CPU."""
    return backward_plain(codes1, len1, codes2, len2, tab)


def posterior(fm, fcap, bm, bcap, len1, len2, tab):
    """Plain version of the posterior kernel (`pairhmm_cuda.posterior`):
    totals (ProbabilisticModel.h:337-365) and match posteriors (:374-403),
    masked to the true lengths, (B, l1max, l2max)."""
    init = tab["init"]
    total_f = fcap[:, 0] + init[0]
    total_f = log_add(total_f, fcap[:, 1] + init[1])
    total_f = log_add(total_f, fcap[:, 2] + init[2])
    total_b = fcap[:, 3] + bcap[:, 0]
    total_b = log_add(total_b, fcap[:, 4] + bcap[:, 1])
    total_b = log_add(total_b, fcap[:, 5] + bcap[:, 2])
    total = (total_f + total_b) / 2.0

    logp = fm[:, 1:, 1:] + bm[:, 1:, 1:] - total[:, None, None]
    post = probcons_exp(torch.clamp(logp, max=0.0))
    l1max, l2max = post.shape[1], post.shape[2]
    dev = post.device
    valid = (
        (torch.arange(1, l1max + 1, device=dev)[None, :, None] <= len1[:, None, None])
        & (torch.arange(1, l2max + 1, device=dev)[None, None, :] <= len2[:, None, None])
    )
    return torch.where(valid, post, 0.0)


def forward_backward_posterior(codes1, len1, codes2, len2, tab):
    """Match posteriors for a batch of sequence pairs, (B, l1max, l2max):
    the three kernels on CUDA tensors, the plain versions on the CPU."""
    fm, fcap = forward(codes1, len1, codes2, len2, tab)
    bm, bcap = backward(codes1, len1, codes2, len2, tab)
    return posterior(fm, fcap, bm, bcap, len1, len2, tab)


def encode_batch(seqs, lmax):
    """(B, lmax+1) int32 1-based codes and (B,) int32 lengths."""
    codes = np.zeros((len(seqs), lmax + 1), dtype=np.int32)
    for b, s in enumerate(seqs):
        codes[b, 1 : len(s) + 1] = P.encode(s)
    return codes, np.array([len(s) for s in seqs], dtype=np.int32)


def batch_posteriors(seqs1, seqs2, threshold, device):
    """Posteriors for aligned-index pairs of raw strings.

    Returns a list of dense float32 (L1, L2) numpy matrices with entries kept
    only when strictly greater than `threshold` (src/align.cpp:69-78).
    """
    if not seqs1:
        return []
    dev = torch.device(device)
    # bucket padding as in the JAX package, so the shapes match its kernels
    l1max = _round_up(max(len(s) for s in seqs1), 32)
    l2max = _round_up(max(len(s) for s in seqs2), 32)
    codes1, len1 = encode_batch(seqs1, l1max)
    codes2, len2 = encode_batch(seqs2, l2max)
    B = len(seqs1)
    args = tuple(torch.from_numpy(a).to(dev) for a in (codes1, len1, codes2, len2))
    post = forward_backward_posterior(*args, tables(dev)).cpu().numpy()
    out = []
    for b in range(B):
        p = post[b, : len1[b], : len2[b]].copy()
        p[p <= threshold] = 0.0
        out.append(p)
    return out
