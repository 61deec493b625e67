"""RNAalifold consensus partition function: host tables and the inside/outside.

Port of `dafs_tpu/ops/alifold_kernel.py` (the JAX package wrote
`alifold_fast` as XLA code, not as a Pallas kernel).

- The host tables (`build_loop_tables`, `build_special_tables`,
  `build_gtabs`, `_hairpin_plane`, `build_planes`) are numpy copies, bit-equal
  to the JAX package's.  The consensus-level planes keep the reference's
  ascending-sequence float32 product order, which is bitwise-significant.
- `build_seq_planes` builds each per-sequence plane as one table gather
  `G[code_i, code_j]`; the JAX version's one-hot contractions (there only to
  avoid gathers on the TPU) have exactly one nonzero term per output, so the
  values are the same bit for bit.
- `alifold_fast` is written in the manner of `mccaskill_kernel.py`: the
  `lax.scan`s over diagonals are Python loops and the dynamic slices at the
  scan index are plain slices or index gathers.  The staircase blocks
  (`STAIR`) and the B-group support cut (`BCUT`) are kept; both are exact.
  Every one-hot stack that the JAX version contracts with a table (the
  loop-size one-hots, the pair-code one-hots, and the 7-way pair-type select
  of the B group) is a table lookup here: each such sum has exactly one
  nonzero term, so the values are unchanged and the eager op count per
  diagonal drops several-fold.  Products over sequences and every stencil
  expression keep the JAX version's operand order; the stencil and row sums
  reduce in PyTorch's order, so results agree with JAX to float32 rounding.

Semantics: ViennaRNA 2.4.x alipfold.c as read by `dafs_tpu/ops/alifold.py`.
A measurement on the card decides whether `alifold_fast` becomes a
hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from dafs_tpu_torch.ops import energy_params as ep

TURN = ep.TURN
MAXLOOP = ep.MAXLOOP

SW = MAXLOOP + 1   # stencil width (u, v in [0, 30])
RP = 64            # top/bottom row padding of diag-major buffers (>= 62)
PAD = 34           # column padding of the per-sequence vectors (>= SW + 2)

# Staircase decomposition of the interior stencil's valid triangle
# (u + v <= MAXLOOP): (v0, v1, u_ext) blocks jointly covering every valid
# (u, v) cell (u < u_ext = SW - v0 suffices since u <= MAXLOOP - v <= 30 - v0).
# Cells inside a block with u + v > 30 are zeroed by SCP / the loop tables,
# exactly as in the full-square evaluation.
STAIR = ((0, 8, 31), (8, 16, 23), (16, 24, 15), (24, 31, 7))

F = np.float32


# =============================== host prep =================================

def build_loop_tables(t: dict) -> dict:
    """31x31 loop-size tables T[u1, u2], one per scalar category.

    Categories mirror intloop_K (`dafs_tpu/ops/alifold.py`): entries are
    ZERO outside the category.  (u1+u2 > 30 cells are unreachable within the
    stencil and left zero.)
    """
    internal = np.asarray(t["internal"], F)
    ninio = np.asarray(t["ninio"], F)
    bulge = np.asarray(t["bulge"], F)
    T_gen = np.zeros((SW, SW), F)
    T_1n = np.zeros((SW, SW), F)
    T_23 = np.zeros((SW, SW), F)
    T_blg = np.zeros((SW, SW), F)
    for u1 in range(SW):
        for u2 in range(SW):
            ns, nl = min(u1, u2), max(u1, u2)
            if u1 + u2 > MAXLOOP:
                continue  # unreachable: u1 <= u, u2 <= v, u+v <= 30
            if nl == 0 or (ns == 0 and nl == 1) or (ns, nl) in (
                (1, 1), (1, 2), (2, 2)
            ):
                continue  # B-group (pair-coupled special cases)
            if ns == 0:
                T_blg[u1, u2] = bulge[nl]
            elif ns == 1:
                T_1n[u1, u2] = internal[min(nl + 1, MAXLOOP)] * ninio[
                    min(nl - 1, MAXLOOP)
                ]
            elif (ns, nl) == (2, 3):
                T_23[u1, u2] = internal[5] * ninio[1]
            else:
                T_gen[u1, u2] = internal[u1 + u2] * ninio[nl - ns]
    # Separable forms of the three non-general categories: each lives on
    # u1/u2 lines, so
    #   T_blg[u1,u2] = [u1==0]*BU[u2] + BU[u1]*[u2==0]        (BU = bulge, >=2)
    #   T_1n [u1,u2] = [u1==1]*F1N[u2] + F1N[u1]*[u2==1]      (F1N gated >=3)
    #   T_23 [u1,u2] = C23*([u1==2][u2==3] + [u1==3][u2==2])
    BU = np.where(np.arange(SW) >= 2, bulge[:SW], 0.0).astype(F)
    F1N = np.array(
        [
            internal[min(x + 1, MAXLOOP)] * ninio[min(x - 1, MAXLOOP)]
            if x >= 3 else 0.0
            for x in range(SW)
        ],
        F,
    )
    C23 = F(internal[5] * ninio[1])
    return dict(T_gen=T_gen, T_1n=T_1n, T_23=T_23, T_blg=T_blg,
                BU=BU, F1N=F1N, C23=C23)


def build_special_tables(t: dict) -> dict:
    """Relaid pair-coupled tables (the B group's small-loop special cases).

    Code packings (pair types shifted to 0..6, NN = 6):
      c175 = (tp-1)*25 + b5*5 + b3   (outer: tp, S3[i], S5[j])
      c35  = (t2)*5 + q              (inner: tp2-1, base)
    """
    stack = np.asarray(t["stack"], F)
    i11 = np.asarray(t["i11"], F)
    i21 = np.asarray(t["i21"], F)
    i22 = np.asarray(t["i22"], F)
    T7 = stack[1:8, 1:8]  # [tp-1, tp2-1]
    # i11: D[c175, t2] = i11[tp, t2+1, b5, b3]
    Ti11 = np.zeros((175, 7), F)
    # i21a (u1=1, u2=2): val = i21[tp, tp2, si1, sq1, sj1]
    Ti21a = np.zeros((175, 35), F)
    # i21b (u1=2, u2=1): val = i21[tp2, tp, sq1, si1, sp1]
    Ti21b = np.zeros((35, 5, 35), F)
    # i22 (2,2): val = i22[tp, tp2, si1, sp1, sq1, sj1]
    Ti22 = np.zeros((175, 5, 35), F)
    for tp in range(1, 8):
        for b5 in range(5):
            for b3 in range(5):
                c = (tp - 1) * 25 + b5 * 5 + b3
                for t2 in range(7):
                    Ti11[c, t2] = i11[tp, t2 + 1, b5, b3]
                    for q in range(5):
                        Ti21a[c, t2 * 5 + q] = i21[tp, t2 + 1, b5, q, b3]
                        for sp1 in range(5):
                            Ti22[c, sp1, t2 * 5 + q] = i22[
                                tp, t2 + 1, b5, sp1, q, b3
                            ]
            c35 = (tp - 1) * 5 + b5
            for sp1 in range(5):
                for t2 in range(7):
                    for q in range(5):
                        Ti21b[c35, sp1, t2 * 5 + q] = i21[
                            t2 + 1, tp, q, b5, sp1
                        ]
    # outside-direction relays: inner code c175_in = (t2)*25 + q*5 + sp1
    Ti21b_o = np.zeros((35, 175), F)
    Ti22_o = np.zeros((175, 175), F)
    for tt in range(7):
        for b in range(5):
            for c in range(5):
                for t2 in range(7):
                    for q in range(5):
                        for sp in range(5):
                            ci = t2 * 25 + q * 5 + sp
                            Ti21b_o[tt * 5 + b, ci] = i21[
                                t2 + 1, tt + 1, q, b, sp
                            ]
                            Ti22_o[tt * 25 + b * 5 + c, ci] = i22[
                                tt + 1, t2 + 1, b, sp, q, c
                            ]
    return dict(T7=T7, Ti11=Ti11, Ti21a=Ti21a, Ti21b=Ti21b, Ti22=Ti22,
                Ti21b_o=Ti21b_o, Ti22_o=Ti22_o,
                blg1=F(np.asarray(t["bulge"], F)[1]))


def build_gtabs(t: dict) -> dict:
    """(25, 25) side-code tables for the per-sequence A-group/code planes.

    Every per-sequence (NS, Lp, Lp) plane is a pure function of a 25-state
    i-side code and a 25-state j-side code (base x nearest-non-gap
    neighbor); `build_seq_planes` gathers them.  Codes:

      OUT-side planes index [u = S_i*5 + S3_i, v = S_j*5 + S5_j]
      IN-side  planes index [u = S_i*5 + S5_i, v = S_j*5 + S3_j]
    """
    RT = np.asarray(ep.RTYPE)
    mmI175 = np.ascontiguousarray(np.asarray(t["mmI"], F)[1:8].reshape(175))
    mm1n175 = np.ascontiguousarray(np.asarray(t["mm1n"], F)[1:8].reshape(175))
    mm23175 = np.ascontiguousarray(np.asarray(t["mm23"], F)[1:8].reshape(175))
    tau = F(t["tau"])

    bi = (np.arange(25) // 5)[:, None]   # base at i (0..4)
    xi = (np.arange(25) % 5)[:, None]    # neighbor letter on the i side
    bj = (np.arange(25) // 5)[None, :]
    yj = (np.arange(25) % 5)[None, :]
    tp = np.asarray(ep.BP_PAIR)[bi, bj].astype(np.int32)
    tp[tp == 0] = 7
    rt = RT[tp]

    # OUT: xi = S3_i, yj = S5_j  (outer pair mismatch letters)
    c175_out = ((tp - 1) * 25 + xi * 5 + yj).astype(np.int32)
    c35_out = ((tp - 1) * 5 + xi).astype(np.int32)
    # IN: xi = S5_i, yj = S3_j  (inner pair, reversed type)
    c175_in = ((rt - 1) * 25 + yj * 5 + xi).astype(np.int32)
    c35_in = ((rt - 1) * 5 + yj).astype(np.int32)

    def tau_of(x):
        return np.where(x > 2, tau, F(1.0)).astype(F)

    return dict(
        G_MMI_OUT=np.take(mmI175, c175_out),
        G_MM1N_OUT=np.take(mm1n175, c175_out),
        G_MM23_OUT=np.take(mm23175, c175_out),
        G_TAU_OUT=tau_of(tp),
        G_MMI_IN=np.take(mmI175, c175_in),
        G_MM1N_IN=np.take(mm1n175, c175_in),
        G_MM23_IN=np.take(mm23175, c175_in),
        G_TAU_IN=tau_of(rt),
        G_C175_OUT=c175_out.astype(F),
        G_C35_OUT=c35_out.astype(F),
        G_C175_IN=c175_in.astype(F),
        G_C35_IN=c35_in.astype(F),
        G_TP7=(tp - 1).astype(F),
        G_RT7=(rt - 1).astype(F),
    )


def _hairpin_plane(t, S, S5, S3, a2s, pt7, tri_code, tetra_code, hexa_code,
                   n, NS, Lp):
    """Consensus hairpin product HP[i, j] (without sc^(d+1)): the product
    over sequences of the gap-aware hairpin factor, in ascending-s order."""
    hairpin = np.asarray(t["hairpin"], F)
    mmH = np.asarray(t["mmH"], F)
    tri = np.asarray(t["tri"], F)
    tetra = np.asarray(t["tetra"], F)
    hexa = np.asarray(t["hexa"], F)
    tau = F(t["tau"])
    lxc = F(t["lxc"])
    HP = np.ones((Lp, Lp), F)
    iidx = np.arange(Lp)
    for s in range(NS):
        ic = iidx[:, None].clip(0, Lp - 1)
        jc = iidx[None, :].clip(0, Lp - 1)
        u = (a2s[s][(jc - 1).clip(0, Lp - 1)] - a2s[s][ic]).clip(min=0)
        tp = pt7[s][ic, jc]
        uc = u.clip(0, MAXLOOP)
        base = hairpin[uc] * np.where(
            u > MAXLOOP, lxc ** (np.log(np.maximum(u, 1).astype(F) / F(30.0))), F(1.0)
        ).astype(F)
        s5 = S3[s][ic]
        s3 = S5[s][jc]
        mm = mmH[tp, s5, s3]
        ta = np.where(tp > 2, tau, F(1.0))
        trv = tri[tri_code[s][ic]]
        tev = tetra[tetra_code[s][ic]]
        hxv = hexa[hexa_code[s][ic]]
        val = np.where(
            u == 3,
            np.where(trv >= 0, trv, base * ta),
            np.where(
                (u == 4) & (tev >= 0),
                tev,
                np.where((u == 6) & (hxv >= 0), hxv, base * mm),
            ),
        ).astype(F)
        val = np.where(u < 3, F(0.0), val)
        val = np.where(a2s[s][ic] < 1, F(1.0), val)
        HP = (HP * val).astype(F)
    return HP


def build_planes(t, S, S5, S3, a2s, pt7, tri_code, tetra_code, hexa_code,
                 n, NS, Lp):
    """Consensus-level host planes (numpy, row-major (Lp, Lp)): the
    sequential-over-s f32 products (MLSTEM/MLCLOSE/EXT, whose multiply order
    is bitwise-significant) and the hairpin product."""
    RT = np.asarray(ep.RTYPE)
    mmM = np.asarray(t["mmM"], F)
    mmExt = np.asarray(t["mmExt"], F)
    d5 = np.asarray(t["d5"], F)
    d3 = np.asarray(t["d3"], F)
    tau = F(t["tau"])
    mli = F(t["mli"])
    mlc = F(t["mlc"])  # already ml_closing**nseq

    iidx = np.arange(Lp)
    ic = iidx[:, None].clip(0, Lp - 1)
    jc = iidx[None, :].clip(0, Lp - 1)

    def tau_of(x):
        return np.where(x > 2, tau, F(1.0))

    # flat-table relays: T175[(tp-1)*25 + b5*5 + b3] == T[tp, b5, b3]
    mmM175 = np.ascontiguousarray(mmM[1:8].reshape(175))
    mmExt175 = np.ascontiguousarray(mmExt[1:8].reshape(175))
    d5f = np.ascontiguousarray(d5.reshape(-1))   # [tp*5 + b]
    d3f = np.ascontiguousarray(d3.reshape(-1))

    tp = pt7                      # (NS, Lp, Lp), values 1..7
    rt = RT[tp]
    si1 = S3[:, :, None]          # base 3' of col i (within seq s)
    sj1 = S5[:, None, :]          # base 5' of col j
    sp1 = S5[:, :, None]
    sq1 = S3[:, None, :]
    TAU_OUT = tau_of(tp).astype(F)
    TAU_IN = tau_of(rt).astype(F)

    # consensus multiloop / exterior products (sequential over s: preserve
    # the reference's ascending-s f32 multiplication order bitwise)
    MLSTEM = np.ones((Lp, Lp), F)
    MLCLOSE = np.ones((Lp, Lp), F)
    EXT = np.ones((Lp, Lp), F)
    ml_f = np.take(mmM175, ((tp - 1) * 25 + sp1 * 5 + sq1)) * TAU_OUT * mli
    mlc_f = np.take(mmM175, ((rt - 1) * 25 + sj1 * 5 + si1)) * TAU_IN * mli
    has5 = ic > 1
    has3 = jc < n
    s5g = np.where(has5[None], sp1, 0)
    s3g = np.where(has3[None], sq1, 0)
    ext_f = np.where(
        (has5 & has3)[None],
        np.take(mmExt175, (tp - 1) * 25 + s5g * 5 + s3g),
        np.where(
            has5[None], np.take(d5f, tp * 5 + s5g),
            np.where(has3[None], np.take(d3f, tp * 5 + s3g), F(1.0)),
        ),
    ) * TAU_OUT
    for s in range(NS):
        MLSTEM = (MLSTEM * ml_f[s]).astype(F)
        MLCLOSE = (MLCLOSE * mlc_f[s]).astype(F)
        EXT = (EXT * ext_f[s]).astype(F)
    MLCLOSE = (MLCLOSE * mlc).astype(F)

    HP = _hairpin_plane(t, S, S5, S3, a2s, pt7, tri_code, tetra_code,
                        hexa_code, n, NS, Lp)
    return dict(MLSTEM=MLSTEM, MLCLOSE=MLCLOSE, EXT=EXT, HP=HP)


# ========================= per-sequence planes (device) =====================

# (plane, gtab, side): OUT planes index [S*5+S3, S*5+S5], IN planes
# [S*5+S5, S*5+S3]
_SEQ_PLANES = (
    ("MMI_IN", "G_MMI_IN", "in"), ("MM1N_IN", "G_MM1N_IN", "in"),
    ("MM23_IN", "G_MM23_IN", "in"), ("TAU_IN", "G_TAU_IN", "in"),
    ("MMI_OUT", "G_MMI_OUT", "out"), ("MM1N_OUT", "G_MM1N_OUT", "out"),
    ("MM23_OUT", "G_MM23_OUT", "out"), ("TAU_OUT", "G_TAU_OUT", "out"),
    ("TP7", "G_TP7", "out"), ("RT7", "G_RT7", "in"),
    ("C175_OUT", "G_C175_OUT", "out"), ("C35_OUT", "G_C35_OUT", "out"),
    ("C175_IN", "G_C175_IN", "in"), ("C35_IN", "G_C35_IN", "in"),
)
_CODE_PLANES = frozenset({"TP7", "RT7", "C175_OUT", "C35_OUT", "C175_IN", "C35_IN"})


def build_seq_planes(gtabs: dict, S, S5, S3) -> dict:
    """Per-sequence A-group/code planes (NS, Lp, Lp) from the (NS, Lp) base
    and neighbor codes: plane[s, i, j] = G[code_i[s, i], code_j[s, j]].
    gtabs: `build_gtabs` tables as float32 tensors on the planes' device.
    The code planes (pair types and pair codes) come back as int64."""
    a = (S * 5 + S3).long()   # (base, S3) side code
    b = (S * 5 + S5).long()   # (base, S5) side code
    out = {}
    for name, key, side in _SEQ_PLANES:
        x, y = (a, b) if side == "out" else (b, a)
        p = gtabs[key][x[:, :, None], y[:, None, :]]
        out[name] = p.long() if name in _CODE_PLANES else p
    return out


# ============================== inside/outside ==============================

def alifold_fast(planes, loop_tabs, spec_tabs, psc_fac, allow_pair,
                 allow_unpaired, S5b, S3b, A2Sb, n, sc, bsn0, *, BCUT=SW):
    """Consensus inside+outside.  Returns (pout (Lp, Lp), Q (0-d)).

    planes: the host planes of `build_planes` (HP/EXT/MLSTEM/MLCLOSE, (Lp,
    Lp) float32) and the `build_seq_planes` planes (NS, Lp, Lp), as tensors
    on one device; loop_tabs/spec_tabs: `build_loop_tables` /
    `build_special_tables` as float32 tensors; psc_fac (Lp, Lp) the
    covariance factor; allow_pair (Lp, Lp) and allow_unpaired (Lp,) bool;
    S5b/S3b/A2Sb (NS, PAD+Lp+Lp+PAD) padded per-sequence vectors; n the
    alignment length; sc the per-column scale and bsn0 = expMLbase**NS
    (numpy float32 scalars).

    BCUT: host-proven support bound for the small-loop-size terms — every
    alignment window of BCUT or more columns holds >= 4 non-gap positions
    in every sequence, so the B-group masks (loop sizes <= 2) and the
    separable A-category indicators (sizes <= 3) vanish at offsets >= BCUT.
    The B group is evaluated on the (u, v < BCUT) corner only; the skipped
    terms are exact zeros, so results equal the full-block evaluation bit
    for bit.
    """
    dev = psc_fac.device
    f32 = torch.float32
    NS = S5b.shape[0]
    Lp = psc_fac.shape[0]
    NROWS = Lp + 2 * RP
    C0 = SW + 2                      # column padding of diag-major buffers
    WC = Lp + 2 * C0
    ii = torch.arange(Lp, device=dev)
    sc_t = torch.tensor(sc, dtype=f32, device=dev)
    bsn = torch.tensor(bsn0, dtype=f32, device=dev) * sc_t
    sc_pow = sc_t ** torch.arange(Lp + 1, device=dev).to(f32)   # sc ** k
    P = planes

    # ---- diag-major layouts: out[RP + dd, C0 + i] = M[i, i + dd] -----------
    dd_g = ii[:, None]
    colg = (ii[None, :] + dd_g).clamp(0, Lp - 1)
    inb = (ii[None, :] + dd_g) <= (Lp - 1)

    def to_ldiag(M):
        body = torch.where(inb, M[..., ii[None, :], colg], 0)
        out = torch.zeros((*M.shape[:-2], NROWS, WC), dtype=M.dtype, device=dev)
        out[..., RP : RP + Lp, C0 : C0 + Lp] = body
        return out

    def row(B, d):
        return B[..., d + RP, C0 : C0 + Lp]

    HPL = to_ldiag(P["HP"])
    EXTL = to_ldiag(P["EXT"])
    MLSTEML = to_ldiag(P["MLSTEM"])
    MLCLOSEL = to_ldiag(P["MLCLOSE"])
    PSCL = to_ldiag(psc_fac)
    APL = to_ldiag(allow_pair.to(f32))
    # A-group channels [4 categories x NS]: MMI (general), MM1N, MM23, TAU
    IN_ST = to_ldiag(torch.cat([P["MMI_IN"], P["MM1N_IN"], P["MM23_IN"], P["TAU_IN"]]))
    OUT_ST = to_ldiag(torch.cat([P["MMI_OUT"], P["MM1N_OUT"], P["MM23_OUT"], P["TAU_OUT"]]))
    TP7L = to_ldiag(P["TP7"])
    RT7L = to_ldiag(P["RT7"])
    C175OL, C35OL = to_ldiag(P["C175_OUT"]), to_ldiag(P["C35_OUT"])
    C175IL, C35IL = to_ldiag(P["C175_IN"]), to_ldiag(P["C35_IN"])

    # ---- stencil gathers ----------------------------------------------------
    # stencil_in:  [c, u, v', i] = CH[c, row d-2-u-(v0+v'), col i+1+u]
    # stencil_out: [c, u, v', i] = CH[c, row d+2+u+(v0+v'), col i-1-u]
    # (zero outside the matrix: the buffers' padding rows and columns)
    _bases: dict = {}

    def stencil(CH, d, outward, u_ext, v0, v1):
        key = (outward, u_ext, v0, v1)
        if key not in _bases:
            u = torch.arange(u_ext, device=dev)[:, None, None]
            v = torch.arange(v0, v1, device=dev)[None, :, None]
            i = ii[None, None, :]
            if outward:
                _bases[key] = (RP + 2 + u + v) * WC + C0 + i - 1 - u
            else:
                _bases[key] = (RP - 2 - u - v) * WC + C0 + i + 1 + u
        return CH.reshape(CH.shape[0], -1)[:, _bases[key] + d * WC]

    # ---- flat lookup tables -------------------------------------------------
    T7f = spec_tabs["T7"].reshape(-1)            # [tp*7 + tp2]
    Ti11f = spec_tabs["Ti11"].reshape(-1)        # [c175*7 + t2]
    Ti21af = spec_tabs["Ti21a"].reshape(-1)      # [c175*35 + m35]
    Ti21bf = spec_tabs["Ti21b"].reshape(-1)      # [(c35*5 + p)*35 + m35]
    Ti22f = spec_tabs["Ti22"].reshape(-1)        # [(c175*5 + p)*35 + m35]
    Ti21b_of = spec_tabs["Ti21b_o"].reshape(-1)  # [c35*175 + c175_in]
    Ti22_of = spec_tabs["Ti22_o"].reshape(-1)    # [c175*175 + c175_in]
    blg1 = spec_tabs["blg1"]
    TGENf = loop_tabs["T_gen"].reshape(-1)       # [u1*SW + u2]
    BU1d = loop_tabs["BU"]
    F1N1d = loop_tabs["F1N"]
    C23 = loop_tabs["C23"]

    # ---- static shift tensors (no d dependence), (NS, SW, Lp) ---------------
    S5b, S3b, A2Sb = S5b.long(), S3b.long(), A2Sb.long()

    def shifted(big, offsets, width=Lp):
        return torch.stack([big[:, o : o + width] for o in offsets], dim=1)

    base_a2s = A2Sb[:, PAD : PAD + Lp]
    U1 = (shifted(A2Sb, [PAD + u for u in range(SW)]) - base_a2s[:, None]).clamp(min=0)
    SP1u = shifted(S5b, [PAD + 1 + u for u in range(SW)])           # S5[s, i+1+u]
    base_m1 = A2Sb[:, PAD - 1 : PAD - 1 + Lp]
    U1o = (base_m1[:, None] - shifted(A2Sb, [PAD - 1 - u for u in range(SW)])).clamp(min=0)
    SI1ou = shifted(S3b, [PAD - 1 - u for u in range(SW)])          # S3[s, i-1-u]

    BU_u, F1N_u = BU1d[U1], F1N1d[U1]
    IND_U = torch.stack([(U1 == a).to(f32) for a in range(4)])       # (4, NS, SW, Lp)
    BU_uo, F1N_uo = BU1d[U1o], F1N1d[U1o]
    IND_UO = torch.stack([(U1o == a).to(f32) for a in range(4)])

    # v-side planes indexed by alignment column (read per diagonal at
    # y = y0 + i).  Inside: V2J[s, v, y] = a2s[y+SW-1] - a2s[y+SW-1-v] and
    # SQ1J[s, v, y] = S3[y+SW-1-v]; outside: V2OJ[s, v, y] = a2s[y+v] - a2s[y]
    # and SJ1OJ[s, v, y] = S5[y+1+v].
    Wv = A2Sb.shape[1] - SW
    V2J = (A2Sb[:, None, SW - 1 : SW - 1 + Wv]
           - shifted(A2Sb, [SW - 1 - v for v in range(SW)], Wv)).clamp(min=0)
    SQ1J = shifted(S3b, [SW - 1 - v for v in range(SW)], Wv)
    V2OJ = (shifted(A2Sb, list(range(SW)), Wv) - A2Sb[:, None, :Wv]).clamp(min=0)
    SJ1OJ = shifted(S5b, [1 + v for v in range(SW)], Wv)
    BU_vJ, F1N_vJ = BU1d[V2J], F1N1d[V2J]
    IND_VJ = torch.stack([(V2J == b).to(f32) for b in range(4)])
    BU_vOJ, F1N_vOJ = BU1d[V2OJ], F1N1d[V2OJ]
    IND_VOJ = torch.stack([(V2OJ == b).to(f32) for b in range(4)])

    uv = torch.arange(SW, device=dev)
    SCP = torch.where(uv[:, None] + uv[None, :] <= MAXLOOP, 1.0, 0.0) * (
        sc_t ** (uv[:, None] + uv[None, :] + 2).to(f32)
    )

    # blocked-segment factors (consensus level)
    logv = torch.where((ii >= 1) & (ii <= n) & allow_unpaired, 1.0, 0.0)
    blocked_pref = torch.cumsum(torch.where(ii >= 1, 1.0 - logv, 0.0), dim=0)
    seg_len = ii[None, :] - ii[:, None] + 1
    seg_blocked = blocked_pref[None, :] - blocked_pref[(ii - 1).clamp(min=0)][:, None]
    bs_seg = torch.where(
        seg_len <= 0, 1.0,
        torch.where(seg_blocked > 0, 0.0, bsn ** seg_len.to(f32)),
    )
    gate_u = allow_unpaired.to(f32)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    def pad_rows(x, top, bottom):
        return torch.cat([zeros(top, x.shape[1]), x, zeros(bottom, x.shape[1])], dim=0)

    def masks(iu, iv):
        """m[a, b] = iu[a] (u-side) x iv[b] (v-side) for the B-group cells."""
        def mm(a, b):
            return iu[a][:, :, None, :] * iv[b][:, None, :, :]
        m00, m01, m10 = mm(0, 0), mm(0, 1), mm(1, 0)
        m_sb = m00 + blg1 * (m01 + m10)
        return m_sb, mm(1, 1), mm(1, 2), mm(2, 1), mm(2, 2)

    kk = ii[None, :]

    # =========================== INSIDE ====================================
    qb_mat, qm, qm1 = zeros(Lp, Lp), zeros(Lp, Lp), zeros(Lp, Lp)
    qm1_prev = zeros(Lp)
    QBL = torch.zeros((1, NROWS, WC), dtype=f32, device=dev)
    # diagonals d >= n hold no cell (i >= 1, i + d <= n): the JAX version
    # scans them to a static length and writes zeros, which is skipped here
    for d in range(1, n):
        j_vec = ii + d
        cell_ok = (ii >= 1) & (j_vec <= n)
        pair_ok = cell_ok & (d > TURN) & (row(APL, d) > 0)

        hp = row(HPL, d) * sc_pow[d + 1]

        y0 = PAD + d - SW
        U2 = V2J[:, :, y0 : y0 + Lp]                     # (NS, SW, Lp)
        SQ1 = SQ1J[:, :, y0 : y0 + Lp]
        BU_v = BU_vJ[:, :, y0 : y0 + Lp]
        F1N_v = F1N_vJ[:, :, y0 : y0 + Lp]
        IND_V = IND_VJ[:, :, :, y0 : y0 + Lp]
        OUTrow = row(OUT_ST, d).reshape(4, NS, 1, 1, Lp)
        # per-diagonal outer pair codes, (NS, 1, 1, Lp)
        tp7 = row(TP7L, d)[:, None, None, :]
        c175 = row(C175OL, d)[:, None, None, :]
        c35 = row(C35OL, d)[:, None, None, :]

        interior = zeros(Lp)
        for v0, v1, u_ext in STAIR:
            vb = v1 - v0
            INst = stencil(IN_ST, d, False, u_ext, v0, v1).reshape(4, NS, u_ext, vb, Lp)
            OI = OUTrow * INst
            Tgen = TGENf[U1[:, :u_ext, None, :] * SW + U2[:, None, v0:v1, :]]
            f1_v = F1N_v[:, None, v0:v1, :]
            bu_v = BU_v[:, None, v0:v1, :]
            if v0 < BCUT:
                iu = IND_U[:, :, :u_ext, None, :]
                iv = IND_V[:, :, None, v0:v1, :]
                T1n = iu[1] * f1_v + F1N_u[:, :u_ext, None, :] * iv[1]
                T23 = C23 * (iu[2] * iv[3] + iu[3] * iv[2])
                Tblg = iu[0] * bu_v + BU_u[:, :u_ext, None, :] * iv[0]
                K = OI[0] * Tgen + OI[1] * T1n + OI[2] * T23 + OI[3] * Tblg
            else:
                # v >= BCUT: the v-side indicators are identically zero, so
                # T23 dies and T1n/Tblg reduce to their u-side indicator
                # terms on the u < BCUT slab (mutually exclusive per cell)
                K = OI[0] * Tgen
                su = min(u_ext, BCUT)
                if su > 0:
                    K[:, :su] += (
                        OI[1][:, :su] * (IND_U[1][:, :su, None, :] * f1_v)
                        + OI[3][:, :su] * (IND_U[0][:, :su, None, :] * bu_v)
                    )
            # B group (pair-coupled small loops) on its support sub-block;
            # each lookup selects the one table entry the JAX version's
            # one-hot contractions and 7-way pair-type select sum to
            bu, bv1 = min(u_ext, BCUT), min(v1, BCUT)
            if bv1 > v0 and bu > 0:
                bvb = bv1 - v0
                TP2 = stencil(RT7L, d, False, bu, v0, bv1)   # inner types 0..6
                m_sb, m11, m12, m21, m22 = masks(IND_U[:, :, :bu], IND_V[:, :, v0:bv1])
                m35 = TP2 * 5 + SQ1[:, None, v0:bv1, :]
                sp = SP1u[:, :bu, None, :]
                Bv = (
                    T7f[tp7 * 7 + TP2] * m_sb + Ti11f[c175 * 7 + TP2] * m11
                    + Ti21af[c175 * 35 + m35] * m12
                    + (Ti21bf[(c35 * 5 + sp) * 35 + m35] * m21
                       + Ti22f[(c175 * 5 + sp) * 35 + m35] * m22)
                )
                K[:, :bu, :bvb] += Bv
            Kp = torch.prod(K, dim=0)                        # (u_ext, vb, Lp)
            M2qb = stencil(QBL, d, False, u_ext, v0, v1)[0]
            interior = interior + torch.einsum("uvi,uvi,uv->i", M2qb, Kp, SCP[:u_ext, v0:v1])

        # multiloop closing
        qm_sh = zeros(Lp, Lp)
        qm_sh[: Lp - 1, 1:] = qm[1:, : Lp - 1]                # qm[i+1, k-1]
        qm1_rows = pad_rows(qm1.T, 4, Lp + 4)[d + 3 : d + 3 + Lp]  # qm1[k, j-1]
        mlk = (kk >= ii[:, None] + 2) & (kk <= j_vec[:, None] - 1)
        mlsum = torch.sum(torch.where(mlk, qm_sh * qm1_rows, 0.0), dim=1)
        ml = mlsum * row(MLCLOSEL, d) * sc_t * sc_t

        qb_new = torch.where(pair_ok, (hp + interior + ml) * row(PSCL, d), 0.0)

        gate_j = torch.where(j_vec <= n, gate_u[j_vec.clamp(max=Lp - 1)], 0.0)
        qm1_new = torch.where(
            cell_ok, qm1_prev * bsn * gate_j + qb_new * row(MLSTEML, d), 0.0
        )
        i_d = ii[: Lp - d]
        qm1[i_d, i_d + d] = qm1_new[: Lp - d]

        pre = zeros(Lp, Lp)
        pre[:, 1:] = bs_seg[:, : Lp - 1] + qm[:, : Lp - 1]
        qm1_rows2 = pad_rows(qm1.T, 4, Lp + 4)[d + 4 : d + 4 + Lp]  # qm1[k, i+d]
        kmask = (kk >= ii[:, None]) & (kk <= j_vec[:, None])
        qm_new = torch.where(
            cell_ok, torch.sum(torch.where(kmask, pre * qm1_rows2, 0.0), dim=1), 0.0
        )
        qm[i_d, i_d + d] = qm_new[: Lp - d]
        qb_mat[i_d, i_d + d] = qb_new[: Lp - d]
        QBL[0, d + RP, C0 : C0 + Lp] = qb_new
        qm1_prev = qm1_new

    # =========================== EXTERIOR ==================================
    ext_m = P["EXT"]
    qb_ext = qb_mat * ext_m

    q1 = zeros(Lp)
    q1[0] = 1.0
    for j in range(1, min(n, Lp - 2) + 1):
        stems = torch.sum(
            torch.where((ii >= 1) & (ii <= j), torch.roll(q1, 1) * qb_ext[:, j], 0.0)
        )
        q1[j] = q1[j - 1] * sc_t * gate_u[j] + stems

    qn = zeros(Lp)
    qn[min(n + 1, Lp - 1)] = 1.0
    for i in range(min(n, Lp - 2), 0, -1):
        stems = torch.sum(
            torch.where((ii >= i) & (ii <= n), qb_ext[i, :] * torch.roll(qn, -1), 0.0)
        )
        qn[i] = qn[i + 1] * sc_t * gate_u[i] + stems
    Q = q1[min(n, Lp - 1)]

    # =========================== OUTSIDE ===================================
    EXL = to_ldiag(ext_m)
    qm_rows_big = pad_rows(qm, 4, Lp + 4)
    bs_rows_big = pad_rows(bs_seg, 4, Lp + 4)
    q1_big = torch.cat([zeros(4), q1, zeros(Lp + 4)])
    qn_big = torch.cat([zeros(4), qn, zeros(Lp + 4)])
    # rows i-1 of qm^T / bs_seg^T, column-padded for the per-diagonal shift
    qmT_sh_big = torch.cat([zeros(Lp, Lp), pad_rows(qm.T, 4, Lp + 4)[3 : 3 + Lp],
                            zeros(Lp, Lp)], dim=1)
    bsT_sh_big = torch.cat([zeros(Lp, Lp), pad_rows(bs_seg.T, 4, Lp + 4)[3 : 3 + Lp],
                            zeros(Lp, Lp)], dim=1)
    # outside A-group stencil channels: OUT planes (outer cells) + psc
    OUT_PSC = torch.cat([OUT_ST, PSCL[None]], dim=0)
    ll = ii[None, :]

    pout, A1, A2 = zeros(Lp, Lp), zeros(Lp, Lp), zeros(Lp, Lp)
    CL = torch.zeros((1, NROWS, WC), dtype=f32, device=dev)
    for d in range(n - 1, 0, -1):
        j_vec = ii + d
        pair_ok = (ii >= 1) & (j_vec <= n) & (d > TURN) & (row(APL, d) > 0)

        w_ext = q1_big[3 : 3 + Lp] * qn_big[d + 5 : d + 5 + Lp] * row(EXL, d) / Q

        y0 = PAD + d
        U2o = V2OJ[:, :, y0 : y0 + Lp]                   # a2s[j+v] - a2s[j]
        SJ1o = SJ1OJ[:, :, y0 : y0 + Lp]                 # S5[s, j+1+v]
        BU_vo = BU_vOJ[:, :, y0 : y0 + Lp]
        F1N_vo = F1N_vOJ[:, :, y0 : y0 + Lp]
        IND_VO = IND_VOJ[:, :, :, y0 : y0 + Lp]
        INrow = row(IN_ST, d).reshape(4, NS, 1, 1, Lp)
        # per-diagonal inner pair codes (this diagonal holds the inner pair)
        rt7 = row(RT7L, d)[:, None, None, :]
        c175i = row(C175IL, d)[:, None, None, :]
        c35i = row(C35IL, d)[:, None, None, :]

        w_int = zeros(Lp)
        for v0, v1, u_ext in STAIR:
            vb = v1 - v0
            OUTst_all = stencil(OUT_PSC, d, True, u_ext, v0, v1)
            OI = INrow * OUTst_all[: 4 * NS].reshape(4, NS, u_ext, vb, Lp)
            PSCst = OUTst_all[4 * NS]
            Tgen = TGENf[U1o[:, :u_ext, None, :] * SW + U2o[:, None, v0:v1, :]]
            f1_v = F1N_vo[:, None, v0:v1, :]
            bu_v = BU_vo[:, None, v0:v1, :]
            if v0 < BCUT:
                iu = IND_UO[:, :, :u_ext, None, :]
                iv = IND_VO[:, :, None, v0:v1, :]
                T1n = iu[1] * f1_v + F1N_uo[:, :u_ext, None, :] * iv[1]
                T23 = C23 * (iu[2] * iv[3] + iu[3] * iv[2])
                Tblg = iu[0] * bu_v + BU_uo[:, :u_ext, None, :] * iv[0]
                K = OI[0] * Tgen + OI[1] * T1n + OI[2] * T23 + OI[3] * Tblg
            else:
                K = OI[0] * Tgen
                su = min(u_ext, BCUT)
                if su > 0:
                    K[:, :su] += (
                        OI[1][:, :su] * (IND_UO[1][:, :su, None, :] * f1_v)
                        + OI[3][:, :su] * (IND_UO[0][:, :su, None, :] * bu_v)
                    )
            bu, bv1 = min(u_ext, BCUT), min(v1, BCUT)
            if bv1 > v0 and bu > 0:
                bvb = bv1 - v0
                TPo = stencil(TP7L, d, True, bu, v0, bv1)    # outer types 0..6
                m_sb, m11, m12, m21, m22 = masks(IND_UO[:, :, :bu], IND_VO[:, :, v0:bv1])
                si = SI1ou[:, :bu, None, :]
                c_out = TPo * 25 + si * 5 + SJ1o[:, None, v0:bv1, :]   # outer c175
                Bv = (
                    T7f[TPo * 7 + rt7] * m_sb
                    + (Ti11f[c_out * 7 + rt7] * m11
                       + Ti21af[c_out * 35 + c35i] * m12
                       + Ti22_of[c_out * 175 + c175i] * m22)
                    + Ti21b_of[(TPo * 5 + si) * 175 + c175i] * m21
                )
                K[:, :bu, :bvb] += Bv
            Kp = torch.prod(K, dim=0) * PSCst
            M2C = stencil(CL, d, True, u_ext, v0, v1)[0]
            w_int = w_int + torch.einsum("uvi,uvi,uv->i", M2C, Kp, SCP[:u_ext, v0:v1])

        # multiloop outside
        qm_r = zeros(Lp, Lp)
        qm_r[:, 1:] = qm_rows_big[d + 5 : d + 5 + Lp, : Lp - 1]   # qm[j+1, l-1]
        e_r = zeros(Lp, Lp)
        e_r[:, 1:] = bs_rows_big[d + 5 : d + 5 + Lp, : Lp - 1]    # bs_seg[j+1, l-1]
        lmask = (ll >= j_vec[:, None] + 1) & (ll <= n)
        mlsum = torch.sum(torch.where(lmask, (A1 + A2) * qm_r + A1 * e_r, 0.0), dim=1)
        w_ml = mlsum * row(MLSTEML, d)

        qb_vec = row(QBL[0], d)
        pnew = torch.where(pair_ok, qb_vec * (w_ext + w_int + w_ml), 0.0)
        i_d = ii[: Lp - d]
        pout[i_d, i_d + d] = pnew[: Lp - d]

        # accumulator updates for this diagonal's outer pairs
        qb_safe_vec = torch.where(qb_vec > 0, qb_vec, 1.0)
        Cvec_i = pnew / qb_safe_vec * row(PSCL, d) * row(MLCLOSEL, d) * sc_t * sc_t
        Cvec_big = torch.cat([zeros(Lp + 4), Cvec_i, zeros(Lp + 4)])
        Cvec_ld = Cvec_big[Lp + 4 - d : Lp + 4 - d + Lp]          # Cvec_i[l - d]
        U1qm = qmT_sh_big[:, Lp + 1 - d : Lp + 1 - d + Lp]        # qm[l-d+1, i-1]
        U2bs = bsT_sh_big[:, Lp + 1 - d : Lp + 1 - d + Lp]        # bs_seg[l-d+1, i-1]
        kd_of_ld = ll - d
        iok = (ii[:, None] > kd_of_ld) & (ii[:, None] < ll) & (kd_of_ld >= 1) & (ll <= n)
        A1 = A1 + torch.where(iok, Cvec_ld[None, :] * U1qm, 0.0)
        A2 = A2 + torch.where(iok, Cvec_ld[None, :] * U2bs, 0.0)

        CL[0, d + RP, C0 : C0 + Lp] = pnew / qb_safe_vec
    return pout, Q
