"""Gather-free McCaskill inside/outside, batched over sequences.

Port of `dafs_tpu/ops/mccaskill_kernel.py::mccaskill_fast` as plain PyTorch
(the JAX package wrote it as XLA code, not as a Pallas kernel).  The JAX
version vmaps one sequence at a time; here the batch dimension is written
out, and the diagonal scans are Python loops, so the JAX dynamic slices at
the scan index become plain slices.  Every expression keeps the JAX
version's operand order; the sums (the 31x31 stencil contractions and the
multiloop row sums) reduce in PyTorch's order, so results agree to float32
rounding, not bit for bit.  Each row's result is independent of the batch
it runs in, on the card too, so a batch split over a work mesh
(`parallel.mesh`) gives the unsplit batch's bits: every sum is either a
reduction whose order PyTorch sets by the row's own extents, or, for the
exterior loop's per-row sums, `tree_sum`.

- the interior-loop stencil is factorized: per-cell "inner side" factors
  (inner pair type + its adjacent bases) are precomputed once, multiplied
  into diagonal-major copies of qb as each diagonal completes, and consumed
  through 31 shifted views; per-(u, s) constants contract with the shifted
  stack as one (31*31) contraction;
- the special stencil positions that couple outer and inner identities
  (stack, 1-bulges, 1x1/2x1/2x2 interiors) use per-diagonal lookups;
- the multiloop outside term is kept in two running (L+2)^2 accumulators.

Argument semantics are those of `ops/mccaskill.py` (1-based positions over a
padded length L; index 0 and L+1 are padding).  A measurement on the card
decides whether this becomes a hand-written kernel.
"""

from __future__ import annotations

import torch

from dafs_tpu_torch.ops import energy_params as ep

TURN = ep.TURN
MAXLOOP = ep.MAXLOOP
SW = MAXLOOP + 1  # stencil width
RP = SW + 5       # top row padding of diag-major buffers


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in a fixed pairwise order, zero-padded to a
    power of two: the same bits whatever the batch size.  (A reduction
    with one output a row, as these are, is ordered by PyTorch's CUDA
    reduce by the number of rows when they are few.)"""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def mccaskill_fast(S, pt, allow_pair, allow_unpaired, n, sc, codes, tabs):
    """Batched inside/outside.

    S (B, L+2) base codes, pt (B, L+2, L+2) pair types, allow_pair
    (B, L+2, L+2) bool, allow_unpaired (B, L+2) bool, n (B,) true lengths,
    sc (B,) float32 per-base scale, codes = (tri, tetra, hexa) k-mer codes
    (B, L+2) each, tabs = `mccaskill._fast_tabs` tensors.
    Returns (pout (B, L+2, L+2) pair probabilities, Q (B,)).
    """
    dev = S.device
    f32 = torch.float32
    B, Lp = S.shape
    NROWS = Lp + 2 * RP
    S = S.long()
    pt = pt.long()
    tri_code, tetra_code, hexa_code = (c.long() for c in codes)
    t = tabs
    ii = torch.arange(Lp, device=dev)
    RT = torch.as_tensor(ep.RTYPE, device=dev).long()
    nb = n.long()[:, None]          # (B, 1)
    scb = sc[:, None]               # (B, 1)
    bs = t["mlb"] * sc              # (B,)

    def tau_of(tpx):
        return torch.where(tpx > 2, t["tau"], 1.0)

    # ---- one-time precomputes ---------------------------------------------
    logv = torch.where((ii >= 1) & (ii <= nb) & allow_unpaired, 1.0, 0.0)
    blocked_pref = torch.cumsum(torch.where(ii >= 1, 1.0 - logv, 0.0), dim=1)
    seg_len = ii[None, :] - ii[:, None] + 1                     # (Lp, Lp)
    seg_blocked = blocked_pref[:, None, :] - blocked_pref[:, (ii - 1).clamp(min=0)][:, :, None]
    seg_ok = (seg_len <= 0) | (seg_blocked == 0)                # (B, Lp, Lp)
    bs_seg = torch.where(
        seg_len <= 0, 1.0,
        torch.where(seg_ok, bs[:, None, None] ** seg_len.to(f32), 0.0),
    )

    rt_mat = RT[pt]
    s_im1 = S[:, (ii - 1).clamp(0, Lp - 1)]  # S[a-1]
    s_ip1 = S[:, (ii + 1).clamp(0, Lp - 1)]  # S[a+1]

    # inner-side per-cell factors for inner pair (a, b)
    F_gen = t["mmI"][rt_mat, s_ip1[:, None, :], s_im1[:, :, None]]
    F_1n = t["mm1n"][rt_mat, s_ip1[:, None, :], s_im1[:, :, None]]
    F_23 = t["mm23"][rt_mat, s_ip1[:, None, :], s_im1[:, :, None]]
    F_tau = tau_of(rt_mat)
    # outer-side per-cell factors (outside pass)
    G_gen = t["mmI"][pt, s_ip1[:, :, None], s_im1[:, None, :]]
    G_1n = t["mm1n"][pt, s_ip1[:, :, None], s_im1[:, None, :]]
    G_23 = t["mm23"][pt, s_ip1[:, :, None], s_im1[:, None, :]]
    G_tau = tau_of(pt)

    # left-diag layouts: out[RP + dd, i] = M[i, i + dd]
    dd_g = ii[:, None]
    colg = (ii[None, :] + dd_g).clamp(0, Lp - 1)
    inb = (ii[None, :] + dd_g) <= (Lp - 1)

    def to_ldiag(M, fill=0.0):
        body = torch.where(inb, M[:, ii[None, :], colg], fill)
        out = torch.full((B, NROWS, Lp), fill, dtype=M.dtype, device=dev)
        out[:, RP : RP + Lp] = body
        return out

    PTL = to_ldiag(pt, 0)
    GL_gen, GL_1n, GL_23, GL_tau = (to_ldiag(G) for G in (G_gen, G_1n, G_23, G_tau))
    FL_gen, FL_1n, FL_23, FL_tau = (to_ldiag(F) for F in (F_gen, F_1n, F_23, F_tau))
    APL = to_ldiag(allow_pair.to(f32))

    C_gen, C_1n, C_23, C_tau = t["C_gen"], t["C_1n"], t["C_23"], t["C_tau"]
    sc_pow = scb ** (torch.arange(SW, device=dev).to(f32) + 2.0)  # (B, SW)

    # strand gates, inside orientation: g1[u, i] = seg_ok[i+1, i+u]
    u_ar = torch.arange(SW, device=dev)[:, None]
    g1_in = seg_ok[:, (ii[None, :] + 1).clamp(0, Lp - 1), (ii[None, :] + u_ar).clamp(0, Lp - 1)]
    g1_in = torch.where(u_ar == 0, True, g1_in).to(f32)
    # outside orientation: g1o[u, i] = seg_ok[i-u, i-1]
    g1_out = seg_ok[:, (ii[None, :] - u_ar).clamp(0, Lp - 1), (ii[None, :] - 1).clamp(0, Lp - 1)]
    g1_out = torch.where(u_ar == 0, True, g1_out).to(f32)

    def shift_rows_down(g2):
        # g2_us[u, s, i] = g2[s - u, i] (zeros where s < u)
        return torch.stack([
            torch.cat([torch.zeros((B, u, Lp), dtype=g2.dtype, device=dev), g2[:, : SW - u]], dim=1)
            for u in range(SW)
        ], dim=1)

    def zeros(*shape, dtype=f32):
        return torch.zeros((B, *shape), dtype=dtype, device=dev)

    blocked_big = torch.cat([zeros(4), blocked_pref, torch.full((B, Lp + 4), 1e9, device=dev)], dim=1)
    S_big = torch.cat([zeros(4, dtype=S.dtype), S, zeros(Lp + 4, dtype=S.dtype)], dim=1)

    def dvec(vec_big, d, off):
        # w[i] = vec[i + d + off]; vec_big has +4 offset.  The start is
        # clamped into range like the JAX version's lax.dynamic_slice.
        start = min(max(d + off + 4, 0), vec_big.shape[1] - Lp)
        return vec_big[:, start : start + Lp]

    def svec(vec_big, off):
        return vec_big[:, off + 4 : off + 4 + Lp]

    def pad_cols(x, left, right):
        return torch.cat([
            torch.zeros((*x.shape[:-1], left), dtype=x.dtype, device=dev), x,
            torch.zeros((*x.shape[:-1], right), dtype=x.dtype, device=dev),
        ], dim=-1)

    def pad_rows(x, top, bottom):
        return torch.cat([
            torch.zeros((B, top, x.shape[2]), dtype=x.dtype, device=dev), x,
            torch.zeros((B, bottom, x.shape[2]), dtype=x.dtype, device=dev),
        ], dim=1)

    def ldiag_row(Bm, d):
        return Bm[:, d + RP]

    def set_diag(M, d, vec):
        """M[:, i, i + d] = vec[:, i] wherever i + d <= Lp - 1."""
        i = ii[: Lp - d]
        M[:, i, i + d] = vec[:, : Lp - d]

    def contract(C, M):
        # sum over (u, s) of C[u, s] * sc_pow[s] * M[u, s, i]; a reduction
        # over two dims that are not the fastest, whose order PyTorch sets by
        # the (u, s, i) extents alone, where a batched product's would
        # depend on the batch (cuBLAS picks by shape)
        Cs = C[None] * sc_pow[:, None, :]
        return (Cs[..., None] * M).sum(dim=(1, 2))

    kk = ii[None, :]

    # =========================== INSIDE ====================================
    qb_mat, qm, qm1 = zeros(Lp, Lp), zeros(Lp, Lp), zeros(Lp, Lp)
    qm1_prev = zeros(Lp)
    QLqb, QL_gen, QL_1n, QL_23, QL_tau = (zeros(NROWS, Lp) for _ in range(5))
    for d in range(1, Lp - 1):
        j_vec = ii + d
        jc = j_vec.clamp(0, Lp - 1)
        cell_ok = (ii >= 1) & (j_vec <= nb)
        pair_ok = cell_ok & (d > TURN) & (ldiag_row(APL, d) > 0)
        tp_vec = ldiag_row(PTL, d)
        sj1 = dvec(S_big, d, -1)   # S[j-1]
        sjp1 = dvec(S_big, d, 1)   # S[j+1]
        si1, sim1 = s_ip1, s_im1

        # --- hairpin ------------------------------------------------------
        u_blk = dvec(blocked_big, d, -1) - blocked_pref  # pref[j-1] - pref[i]
        hp_open = u_blk == 0.0
        d_size = d - 1
        base = t["hairpin"][min(max(d_size, 0), MAXLOOP)]
        if d_size > MAXLOOP:
            ratio = torch.tensor(float(max(d_size, 1)), device=dev) / 30.0
            base = base * t["lxc"] ** torch.log(ratio)
        mmh = t["mmH"][tp_vec, si1, sj1]
        tri = t["tri"][tri_code]
        tetra = t["tetra"][tetra_code]
        hexa = t["hexa"][hexa_code]
        if d_size == 3:
            hp_val = torch.where(tri >= 0, tri, base * tau_of(tp_vec))
        elif d_size == 4:
            hp_val = torch.where(tetra >= 0, tetra, base * mmh)
        elif d_size == 6:
            hp_val = torch.where(hexa >= 0, hexa, base * mmh)
        else:
            hp_val = base * mmh
        hp = torch.where(hp_open & (d_size >= 3), hp_val, 0.0) * scb ** float(d + 1)

        # --- interior: factorized stencil ---------------------------------
        prefs_jm1 = dvec(blocked_big, d, -1)
        prefs_jv = torch.stack([dvec(blocked_big, d, -v) for v in range(SW)], dim=1)
        g2_in = (prefs_jm1[:, None, :] - prefs_jv) == 0.0
        g2_in = torch.where(torch.arange(SW, device=dev)[:, None] <= 1, True, g2_in).to(f32)
        g2_us = shift_rows_down(g2_in)

        def stencil(QL):
            r0 = d + RP - 2 - MAXLOOP
            rows = QL[:, r0 : r0 + SW].flip(1)  # s = 0..30
            rows_p = pad_cols(rows, 0, SW + 2)
            return torch.stack([rows_p[:, :, 1 + u : 1 + u + Lp] for u in range(SW)], dim=1)

        def cat_sum(QL, C, outer_vec):
            M = stencil(QL) * g1_in[:, :, None, :] * g2_us
            return contract(C, M) * outer_vec

        interior = (
            cat_sum(QL_gen, C_gen, ldiag_row(GL_gen, d))
            + cat_sum(QL_1n, C_1n, ldiag_row(GL_1n, d))
            + cat_sum(QL_23, C_23, ldiag_row(GL_23, d))
            + cat_sum(QL_tau, C_tau, ldiag_row(GL_tau, d))
        )

        # --- special positions --------------------------------------------
        def ql_row(QL, s, shift):
            rp = pad_cols(ldiag_row(QL, d - 2 - s), 0, SW + 2)
            return rp[:, shift : shift + Lp]

        def tp2_of(s, shift):
            rp = pad_cols(ldiag_row(PTL, d - 2 - s), 0, SW + 2)
            return RT[rp[:, shift : shift + Lp]]

        sp2 = svec(S_big, 2)      # S[i+2]
        sq_m1 = dvec(S_big, d, -1)
        sq_m2 = dvec(S_big, d, -2)

        t00 = ql_row(QLqb, 0, 1) * t["stack"][tp_vec, tp2_of(0, 1)] * sc_pow[:, 0:1]
        t01 = ql_row(QLqb, 1, 1) * t["bulge"][1] * t["stack"][tp_vec, tp2_of(1, 1)] * sc_pow[:, 1:2]
        t10 = ql_row(QLqb, 1, 2) * t["bulge"][1] * t["stack"][tp_vec, tp2_of(1, 2)] * sc_pow[:, 1:2]
        t11 = ql_row(QLqb, 2, 2) * t["i11"][tp_vec, tp2_of(2, 2), si1, sj1] * sc_pow[:, 2:3]
        t12 = ql_row(QLqb, 3, 2) * t["i21"][tp_vec, tp2_of(3, 2), si1, sq_m2, sj1] * sc_pow[:, 3:4]
        t21 = ql_row(QLqb, 3, 3) * t["i21"][tp2_of(3, 3), tp_vec, sq_m1, si1, sp2] * sc_pow[:, 3:4]
        t22 = ql_row(QLqb, 4, 3) * t["i22"][tp_vec, tp2_of(4, 3), si1, sp2, sq_m2, sj1] * sc_pow[:, 4:5]

        def gate(u, v):
            return g1_in[:, u] * g2_in[:, v]

        interior = (
            interior
            + t00 * gate(0, 0)
            + t01 * gate(0, 1) + t10 * gate(1, 0)
            + t11 * gate(1, 1)
            + t12 * gate(1, 2) + t21 * gate(2, 1)
            + t22 * gate(2, 2)
        )

        # --- multiloop closing --------------------------------------------
        qm_sh = zeros(Lp, Lp)
        qm_sh[:, : Lp - 1, 1:] = qm[:, 1:, : Lp - 1]       # qm[i+1, k-1]
        qm1_rows = pad_rows(qm1.transpose(1, 2), 4, Lp + 4)[:, d + 3 : d + 3 + Lp]  # qm1[k, j-1]
        mlk = (kk >= ii[:, None] + 2) & (kk <= j_vec[:, None] - 1)
        mlsum = torch.sum(torch.where(mlk, qm_sh * qm1_rows, 0.0), dim=2)
        rt_vec = RT[tp_vec]
        mlclose = t["mmM"][rt_vec, sj1, si1] * tau_of(rt_vec) * t["mli"] * t["mlc"]
        ml = mlsum * mlclose * scb * scb

        qb_new = torch.where(pair_ok, hp + interior + ml, 0.0)

        # --- qm1 ----------------------------------------------------------
        gate_j = torch.where((j_vec <= nb) & allow_unpaired[:, jc], 1.0, 0.0)
        stem_f = t["mmM"][tp_vec, sim1, sjp1] * tau_of(tp_vec) * t["mli"]
        qm1_new = torch.where(cell_ok, qm1_prev * bs[:, None] * gate_j + qb_new * stem_f, 0.0)
        set_diag(qm1, d, qm1_new)

        # --- qm -----------------------------------------------------------
        pre = zeros(Lp, Lp)
        pre[:, :, 1:] = bs_seg[:, :, : Lp - 1] + qm[:, :, : Lp - 1]
        qm1_rows2 = pad_rows(qm1.transpose(1, 2), 4, Lp + 4)[:, d + 4 : d + 4 + Lp]  # qm1(k, i+d)
        kmask = (kk >= ii[:, None]) & (kk <= j_vec[:, None])
        qm_new = torch.where(
            cell_ok, torch.sum(torch.where(kmask, pre * qm1_rows2, 0.0), dim=2), 0.0
        )
        set_diag(qm, d, qm_new)
        set_diag(qb_mat, d, qb_new)

        QLqb[:, d + RP] = qb_new
        QL_gen[:, d + RP] = qb_new * ldiag_row(FL_gen, d)
        QL_1n[:, d + RP] = qb_new * ldiag_row(FL_1n, d)
        QL_23[:, d + RP] = qb_new * ldiag_row(FL_23, d)
        QL_tau[:, d + RP] = qb_new * ldiag_row(FL_tau, d)
        qm1_prev = qm1_new

    # =========================== EXTERIOR ==================================
    i_g = ii[:, None]
    j_g = ii[None, :]
    s5g = torch.where(i_g > 1, S[:, (i_g - 1).clamp(0, Lp - 1)], 0)   # (B, Lp, 1)
    s3g = torch.where(j_g < nb[:, :, None], S[:, (j_g + 1).clamp(0, Lp - 1)], 0)  # (B, 1, Lp)
    both_g = (i_g > 1) & (j_g < nb[:, :, None])
    ext_m = torch.where(
        both_g,
        t["mmExt"][pt, s5g, s3g],
        torch.where(
            i_g > 1, t["d5"][pt, s5g],
            torch.where(j_g < nb[:, :, None], t["d3"][pt, s3g], 1.0),
        ),
    ) * tau_of(pt)
    qb_ext = qb_mat * ext_m

    q1 = zeros(Lp)
    q1[:, 0] = 1.0
    for j in range(1, Lp - 1):
        gate_j = torch.where(allow_unpaired[:, j], 1.0, 0.0)
        stems = tree_sum(
            torch.where((ii >= 1) & (ii <= j), torch.roll(q1, 1, dims=1) * qb_ext[:, :, j], 0.0))
        val = q1[:, j - 1] * sc * gate_j + stems
        q1[:, j] = torch.where(j <= n, val, q1[:, j])

    qn = zeros(Lp)
    qn[torch.arange(B, device=dev), (n.long() + 1).clamp(0, Lp - 1)] = 1.0
    for i in range(Lp - 2, 0, -1):
        gate_i = torch.where(allow_unpaired[:, i], 1.0, 0.0)
        stems = tree_sum(
            torch.where((ii >= i) & (ii <= nb), qb_ext[:, i, :] * torch.roll(qn, -1, dims=1), 0.0))
        val = qn[:, i + 1] * sc * gate_i + stems
        qn[:, i] = torch.where(i <= n, val, qn[:, i])
    Q = q1[torch.arange(B, device=dev), n.long().clamp(0, Lp - 1)]

    # =========================== OUTSIDE ===================================
    QBL = to_ldiag(qb_mat)
    EXL = to_ldiag(ext_m)
    qmT_big = pad_rows(qm.transpose(1, 2), 4, Lp + 4)
    bsT_big = pad_rows(bs_seg.transpose(1, 2), 4, Lp + 4)
    qm_rows_big = pad_rows(qm, 4, Lp + 4)
    bs_rows_big = pad_rows(bs_seg, 4, Lp + 4)
    q1_big = torch.cat([zeros(4), q1, zeros(Lp + 4)], dim=1)
    qn_big = torch.cat([zeros(4), qn, zeros(Lp + 4)], dim=1)
    sp_m1 = svec(S_big, -1)  # S[i-1]
    sp_m2 = svec(S_big, -2)  # S[i-2]
    # rows i-1 of qm^T / bs_seg^T, column-padded for the per-diagonal shift
    qmT_sh_big = pad_cols(qmT_big[:, 3 : 3 + Lp], Lp, Lp)
    bsT_sh_big = pad_cols(bsT_big[:, 3 : 3 + Lp], Lp, Lp)
    ll = ii[None, :]

    pout, A1, A2 = zeros(Lp, Lp), zeros(Lp, Lp), zeros(Lp, Lp)
    CL_gen, CL_1n, CL_23, CL_tau, CLqb = (zeros(NROWS, Lp) for _ in range(5))
    for d in range(Lp - 2, 0, -1):
        j_vec = ii + d
        pair_ok = (ii >= 1) & (j_vec <= nb) & (d > TURN) & (ldiag_row(APL, d) > 0)
        tp_vec = ldiag_row(PTL, d)
        rt_vec = RT[tp_vec]
        sj1 = dvec(S_big, d, -1)
        sjp1 = dvec(S_big, d, 1)
        si1, sim1 = s_ip1, s_im1

        w_ext = svec(q1_big, -1) * dvec(qn_big, d, 1) * ldiag_row(EXL, d) / Q[:, None]

        # outer-strand gates
        prefs_j0 = dvec(blocked_big, d, 0)
        prefs_jv = torch.stack([dvec(blocked_big, d, v) for v in range(SW)], dim=1)
        g2_out = (prefs_jv - prefs_j0[:, None, :]) == 0.0
        g2_out = torch.where(torch.arange(SW, device=dev)[:, None] == 0, True, g2_out).to(f32)
        g2o_us = shift_rows_down(g2_out)

        def stencil_out(CL):
            rows = CL[:, d + RP + 2 : d + RP + 2 + SW]  # s = 0..30
            rows_p = pad_cols(rows, SW + 2, 0)
            return torch.stack(
                [rows_p[:, :, SW + 1 - u : SW + 1 - u + Lp] for u in range(SW)], dim=1
            )

        in_gen = t["mmI"][rt_vec, sjp1, sim1]
        in_1n = t["mm1n"][rt_vec, sjp1, sim1]
        in_23 = t["mm23"][rt_vec, sjp1, sim1]
        in_tau = tau_of(rt_vec)

        def cat_sum_out(CL, C, inner_vec):
            M = stencil_out(CL) * g1_out[:, :, None, :] * g2o_us
            return contract(C, M) * inner_vec

        w_int = (
            cat_sum_out(CL_gen, C_gen, in_gen)
            + cat_sum_out(CL_1n, C_1n, in_1n)
            + cat_sum_out(CL_23, C_23, in_23)
            + cat_sum_out(CL_tau, C_tau, in_tau)
        )

        def cl_row(CL, s, u):
            rp = pad_cols(ldiag_row(CL, d + 2 + s), SW + 2, 0)
            return rp[:, SW + 1 - u : SW + 1 - u + Lp]

        def tpo_of(s, u):
            rp = pad_cols(ldiag_row(PTL, d + 2 + s), SW + 2, 0)
            return rp[:, SW + 1 - u : SW + 1 - u + Lp]

        sq_p1 = dvec(S_big, d, 1)
        sq_p2 = dvec(S_big, d, 2)

        o00 = cl_row(CLqb, 0, 0) * t["stack"][tpo_of(0, 0), rt_vec] * sc_pow[:, 0:1]
        o01 = cl_row(CLqb, 1, 0) * t["bulge"][1] * t["stack"][tpo_of(1, 0), rt_vec] * sc_pow[:, 1:2]
        o10 = cl_row(CLqb, 1, 1) * t["bulge"][1] * t["stack"][tpo_of(1, 1), rt_vec] * sc_pow[:, 1:2]
        o11 = cl_row(CLqb, 2, 1) * t["i11"][tpo_of(2, 1), rt_vec, sp_m1, sq_p1] * sc_pow[:, 2:3]
        o12 = cl_row(CLqb, 3, 1) * t["i21"][tpo_of(3, 1), rt_vec, sp_m1, sjp1, sq_p2] * sc_pow[:, 3:4]
        o21 = cl_row(CLqb, 3, 2) * t["i21"][rt_vec, tpo_of(3, 2), sjp1, sp_m2, sim1] * sc_pow[:, 3:4]
        o22 = cl_row(CLqb, 4, 2) * t["i22"][tpo_of(4, 2), rt_vec, sp_m2, sim1, sjp1, sq_p2] * sc_pow[:, 4:5]

        def gate_o(u, v):
            return g1_out[:, u] * g2_out[:, v]

        w_int = (
            w_int
            + o00 * gate_o(0, 0)
            + o01 * gate_o(0, 1) + o10 * gate_o(1, 0)
            + o11 * gate_o(1, 1)
            + o12 * gate_o(1, 2) + o21 * gate_o(2, 1)
            + o22 * gate_o(2, 2)
        )

        # multiloop outside
        qm_r = zeros(Lp, Lp)
        qm_r[:, :, 1:] = qm_rows_big[:, d + 5 : d + 5 + Lp, : Lp - 1]   # qm[j+1, l-1]
        e_r = zeros(Lp, Lp)
        e_r[:, :, 1:] = bs_rows_big[:, d + 5 : d + 5 + Lp, : Lp - 1]    # bs_seg[j+1, l-1]
        lmask = (ll >= j_vec[:, None] + 1) & (ll <= nb[:, :, None])
        mlsum = torch.sum(torch.where(lmask, (A1 + A2) * qm_r + A1 * e_r, 0.0), dim=2)
        stem_f = t["mmM"][tp_vec, sim1, sjp1] * tau_of(tp_vec) * t["mli"]
        w_ml = mlsum * stem_f

        qb_vec = ldiag_row(QBL, d)
        pnew = torch.where(pair_ok, qb_vec * (w_ext + w_int + w_ml), 0.0)
        set_diag(pout, d, pnew)

        # accumulator updates for this diagonal's outer pairs
        qb_safe_vec = torch.where(qb_vec > 0, qb_vec, 1.0)
        close_f = t["mmM"][rt_vec, sj1, si1] * tau_of(rt_vec) * t["mli"] * t["mlc"]
        Cvec_i = pnew / qb_safe_vec * close_f * scb * scb
        Cvec_big = torch.cat([zeros(Lp + 4), Cvec_i, zeros(Lp + 4)], dim=1)
        Cvec_ld = Cvec_big[:, Lp + 4 - d : Lp + 4 - d + Lp]  # Cvec[ld] = Cvec_i[ld - d]
        U1qm = qmT_sh_big[:, :, Lp + 1 - d : Lp + 1 - d + Lp]   # qm[ld-d+1, i-1]
        U2bs = bsT_sh_big[:, :, Lp + 1 - d : Lp + 1 - d + Lp]   # bs_seg[ld-d+1, i-1]
        kd_of_ld = ll - d
        iok = (
            (ii[:, None] > kd_of_ld) & (ii[:, None] < ll) & (kd_of_ld >= 1)
            & (ll <= nb[:, :, None])
        )
        A1 = A1 + torch.where(iok, Cvec_ld[:, None, :] * U1qm, 0.0)
        A2 = A2 + torch.where(iok, Cvec_ld[:, None, :] * U2bs, 0.0)

        Cint = pnew / qb_safe_vec
        CL_gen[:, d + RP] = Cint * ldiag_row(GL_gen, d)
        CL_1n[:, d + RP] = Cint * ldiag_row(GL_1n, d)
        CL_23[:, d + RP] = Cint * ldiag_row(GL_23, d)
        CL_tau[:, d + RP] = Cint * ldiag_row(GL_tau, d)
        CLqb[:, d + RP] = Cint
    return pout, Q
