"""The McCaskill fold's CUDA path on the CPU: what can be checked without a card.

The kernels of `csrc/mccaskill.cu` run only on the card (`tests/test_torch_cuda.py`
and `chip_smoke.py` hold them to the plain version there).  Here:

- the ctypes struct has the C struct's fields in its order;
- what `mccaskill_cuda.prepare` and `pack` build (the per-cell factors, the
  pair codes, letters and blocked prefix, the compact list of pair-allowed
  cells, the stencil slots and their constants, the flat tables, the
  attempt's scale powers and bs_seg) indexes back to the plain version's
  tensors;
- `emulate`, a numpy transcription of the three kernels that reads only the
  packed arguments, with their indexing, cell lists, lane order, butterfly
  sums and the exterior's forward push, agrees with the plain version at
  the tolerance the card's run is held to (rtol 2e-4; atol 1e-6 on pout),
  and, run through the port's pf-scale ladder, with `dafs_tpu`'s
  `batch_bp_posteriors_fast` at `tests/test_torch_mccaskill.py`'s
  tolerance (atol 3e-5, rtol 3e-3): mixed lengths, a constraint, a
  sequence whose first attempt overflows, bl True and False; from a scale
  at which Q overflows every attempt reads as the plain version's;
- on the CPU the fold takes the plain version and launches nothing.
"""

import os
import re

import numpy as np
import pytest
import torch

from dafs_tpu.ops import mccaskill as j_mc
from dafs_tpu_torch import params
from dafs_tpu_torch.ops import cuda_lib
from dafs_tpu_torch.ops import energy_params as ep
from dafs_tpu_torch.ops import mccaskill as t_mc
from dafs_tpu_torch.ops import mccaskill_cuda as mcu
from dafs_tpu_torch.ops import mccaskill_kernel as MK

torch.set_num_threads(1)

CARD = dict(rtol=2e-4, atol=1e-6)
JAX_TOL = dict(atol=3e-5, rtol=3e-3)
CU = os.path.join(os.path.dirname(MK.__file__), os.pardir, "csrc", "mccaskill.cu")
OVERFLOW = "GGGGGGCCCCCC" * 6  # Q >= 1e25 at the first scale


def _rna(rng, n):
    return "".join(rng.choice(list("ACGU"), size=n))


def _bucket(seqs, constraints=None, bl=True, pad=0):
    """`mccaskill_fast`'s arguments for one bucket, as
    `batch_bp_posteriors_fast` builds them (`pad` trivial length-1 rows
    after the sequences, as a mesh's padding)."""
    L = t_mc._round_up(max(len(s) for s in seqs), 32)
    S, PT, AP, AU, ns = t_mc.bucket_inputs(seqs, L, len(seqs) + pad, constraints)
    t = torch.from_numpy
    args = (t(S), t(PT), t(AP), t(AU), t(ns))
    return args, t_mc.kmer_codes(args[0]), params.to_device(t_mc._fast_tabs(bl), "cpu")


CASES = {
    "mixed": (lambda r: [_rna(r, 40), _rna(r, 57), _rna(r, 61)], None, True, 0),
    "vienna": (lambda r: [_rna(r, 45), _rna(r, 38)], None, False, 0),
    "constrained": (lambda r: ["GGGGAAAACCCCAUAUGCGCUUCGGCGCAAAGGGAAACCCUUU"],
                    ["((((....))))" + "x" * 3 + "." * 28], True, 0),
    "padded": (lambda r: [_rna(r, 33), "GCGCUUCGGCGCAAAGCGCUUCGGCGC"], None, True, 2),
    "short": (lambda r: ["GGGAAAACCC", "GCGCUUCGGCGC", "AUAUAUAUAUAUAU"], None, True, 0),
}


def _case(name):
    make, con, bl, pad = CASES[name]
    seqs = make(np.random.default_rng(7))
    return seqs, con, bl, pad


def _inputs(name):
    seqs, con, bl, pad = _case(name)
    return _bucket(seqs, con, bl, pad)


# ------------------------------------------------------------ the kernels --
# A numpy transcription of csrc/mccaskill.cu: the same buffers and offsets, a
# scan's step one diagonal with its cells taken together (a warp's lanes as
# the last axis of 32), the grid barrier between steps.  Within a step the
# kernels' warps touch disjoint entries.

LANES = np.arange(32)


def _lanes(terms):
    """(cells, 32): each lane's sum of its terms, in order (term e to lane
    e % 32, round e // 32), as a warp's loop adds them; a missing term adds
    +0, which leaves the sum's bits as they are."""
    nc, ne = terms.shape
    r = -(-ne // 32) if ne else 0
    pad = np.zeros((nc, r * 32), np.float32)
    pad[:, :ne] = terms
    acc = np.zeros((nc, 32), np.float32)
    for k in range(r):
        acc = acc + pad[:, 32 * k : 32 * (k + 1)]
    return acc


def _butterfly(x):
    """warp_sum: x += shfl_xor(x, off) for off = 16 .. 1; lane 0's value."""
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, LANES ^ off]
    return x[:, 0]


def emulate(pk):
    """(pout (B, Lp, Lp), Q (B,)) of the three kernels on `pack`'s
    arguments."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return _emulate(pk)


def _emulate(pk):
    f32 = np.float32
    T = {k: v.numpy() for k, v in pk["tensors"].items()}   # the state is written in place
    I = pk["ints"]
    B, lp, maxn, nslots = I["nb"], I["lp"], I["maxn"], I["nslots"]
    cellf, code, seq, blk = T["cellf"], T["code"].astype(np.int64), T["seq"], T["blk"]
    gate_u, nlen, pairs, pair_off = T["gate_u"], T["nlen"], T["pairs"], T["pair_off"]
    tb, sc, bs, scs, sc_pow, K, bs_seg = (T[k] for k in ("tabs", "sc", "bs", "scs", "sc_pow",
                                                         "kslot", "bs_seg"))
    su, sv = T["slots"] & 255, T["slots"] >> 8
    beg = [0, I["s_1n"], I["s_23"], I["s_tau"], nslots]
    qbl, ql, qbx, qbxt, qm, qm1t = (T[k] for k in ("qbl", "ql", "qbx", "qbxt", "qm", "qm1t"))
    q1, qn, q, cl, clc, cm, a1, a2, pout = (T[k] for k in ("q1", "qn", "q", "cl", "clc", "cm",
                                                          "a1", "a2", "pout"))
    Sx = lambda b, k: seq[b, mcu.SPAD + k]  # noqa: E731  (S[b][k], zero padded)
    o_st, o_11, o_21, o_22, o_b1 = (I[k] for k in ("o_stack", "o_i11", "o_i21", "o_i22",
                                                   "o_bulge1"))

    def seg_ok(b, p, q_):
        return (q_ - p + 1 <= 0) | (blk[b, q_] == blk[b, np.maximum(p - 1, 0)])

    def gates(b, i, j, inside):
        x = LANES[None, :]
        b_, i_, j_ = b[:, None], i[:, None], j[:, None]
        if inside:
            g1 = (x == 0) | seg_ok(b_, np.clip(i_ + 1, 0, lp - 1), np.clip(i_ + x, 0, lp - 1))
            g2 = (x <= 1) | (blk[b_, j_ - 1] == blk[b_, np.clip(j_ - x, 0, lp - 1)])
        else:
            g1 = (x == 0) | seg_ok(b_, np.clip(i_ - x, 0, lp - 1), np.clip(i_ - 1, 0, lp - 1))
            g2 = (x == 0) | ((j_ + x <= lp - 1)
                             & (blk[b_, np.clip(j_ + x, 0, lp - 1)] == blk[b_, j_]))
        return g1, g2

    def qm_row(b, i, j, d):
        k = i[:, None] + 1 + np.arange(d)[None, :]
        b_, i_, j_ = b[:, None], i[:, None], j[:, None]
        return _lanes((bs_seg[b_, i_, k - 1] + qm[b_, i_, k - 1]) * qm1t[b_, j_, k])

    def finish_qm(b, i, j, qb, stem, rest):
        prev = qm1t[b, j - 1, i]
        m1 = prev * bs[b] * gate_u[b, j] + qb * stem
        qm1t[b, j, i] = m1
        qm[b, i, j] = rest + (bs_seg[b, i, i - 1] + qm[b, i, i - 1]) * m1

    # ---------------------------------------------------- dafs_mccaskill_inside
    for d in range(1, maxn):
        e = pairs[pair_off[d] : pair_off[d + 1]]
        b, i = e >> 16, e & 0xFFFF
        j = i + d
        if len(e):
            f = cellf[b, i, j]
            g1, g2 = gates(b, i, j, True)
            smax = d - 6
            part = np.zeros((len(e), 32), f32)
            for c in range(4):
                t = np.arange(beg[c], beg[c + 1])
                t = t[su[t] + sv[t] <= smax]
                u, v = su[t][None, :], sv[t][None, :]
                x = ql[b[:, None], d - 2 - u - v, i[:, None] + 1 + u, c]
                x = x * (g1[:, u[0]] & g2[:, v[0]]).astype(f32)
                part = part + _lanes(K[b[:, None], t[None, :]] * x) * f[:, 4 + c][:, None]
            tp = code[b, i, j] & 7
            si1, si2, sj1, sj2 = (Sx(b, i + 1), Sx(b, i + 2), Sx(b, j - 1), Sx(b, j - 2))
            for k, (u, v) in enumerate(mcu.SPECIAL):
                if u + v > smax:
                    continue
                p, q_ = i + 1 + u, j - 1 - v
                qbv = qbl[b, q_ - p, p]
                tp2 = (code[b, p, q_] >> 3) & 7
                sb = scs[b]
                if k == 0:
                    term = qbv * tb[o_st + tp * 8 + tp2] * sb[:, 0]
                elif k in (1, 2):
                    term = qbv * tb[o_b1] * tb[o_st + tp * 8 + tp2] * sb[:, 1]
                elif k == 3:
                    term = qbv * tb[o_11 + ((tp * 8 + tp2) * 5 + si1) * 5 + sj1] * sb[:, 2]
                elif k == 4:
                    term = qbv * tb[o_21 + (((tp * 8 + tp2) * 5 + si1) * 5 + sj2) * 5 + sj1] \
                        * sb[:, 3]
                elif k == 5:
                    term = qbv * tb[o_21 + (((tp2 * 8 + tp) * 5 + sj1) * 5 + si1) * 5 + si2] \
                        * sb[:, 3]
                else:
                    term = qbv * tb[o_22 + ((((tp * 8 + tp2) * 5 + si1) * 5 + si2) * 5 + sj2) * 5
                                    + sj1] * sb[:, 4]
                part[:, k] = part[:, k] + term * (g1[:, u] & g2[:, v]).astype(f32)
            kk = i[:, None] + 2 + np.arange(max(d - 2, 0))[None, :]
            ml = _lanes(qm[b[:, None], i[:, None] + 1, kk - 1] * qm1t[b[:, None], j[:, None] - 1, kk])
            rest = _butterfly(qm_row(b, i, j, d))
            interior = _butterfly(part)
            ml = _butterfly(ml)
            hp = f[:, 8] * sc_pow[b, d + 1]
            qb = (hp + interior) + ml * f[:, 10] * sc[b] * sc[b]
            qbl[b, d, i] = qb
            ql[b, d, i] = qb[:, None] * f[:, :4]
            qbx[b, i, j] = qb * f[:, 11]
            qbxt[b, j, i] = qb * f[:, 11]
            finish_qm(b, i, j, qb, f[:, 9], rest)
        # the other cells: qm1 and qm only
        bb, ii = np.meshgrid(np.arange(B), np.arange(1, maxn - d + 1), indexing="ij")
        bb, ii = bb.reshape(-1), ii.reshape(-1)
        keep = (ii + d <= nlen[bb]) & ~((d > MK.TURN) & ((code[bb, ii, np.minimum(ii + d, lp - 1)]
                                                          >> 6) > 0))
        b, i = bb[keep], ii[keep]
        if len(b):
            j = i + d
            rest = _butterfly(qm_row(b, i, j, d))
            finish_qm(b, i, j, f32(0), cellf[b, i, j, 9], rest)

    # ------------------------------------------------- dafs_mccaskill_exterior
    cols = np.arange(lp)
    for b in range(B):
        n, s_ = int(nlen[b]), sc[b]
        chain = np.zeros(lp, f32)
        acc = np.zeros(lp, f32)
        chain[0] = 1
        for k in range(n):
            m = (cols > k) & (cols <= n)
            acc[m] = acc[m] + chain[k] * qbx[b, k + 1, m]
            chain[k + 1] = chain[k] * s_ * gate_u[b, k + 1] + acc[k + 1]
        q1[b], q[b] = chain, chain[n]
        chain = np.zeros(lp, f32)
        acc = np.zeros(lp, f32)
        chain[n + 1] = 1
        for mm in range(n + 1, 1, -1):
            m = (cols >= 1) & (cols <= mm - 1)
            acc[m] = acc[m] + qbxt[b, mm - 1, m] * chain[mm]
            chain[mm - 1] = chain[mm] * s_ * gate_u[b, mm - 1] + acc[mm - 1]
        qn[b] = chain

    # -------------------------------------------------- dafs_mccaskill_outside
    for d in range(maxn - 1, 0, -1):
        e = pairs[pair_off[d] : pair_off[d + 1]]
        b, i = e >> 16, e & 0xFFFF
        j = i + d
        if len(e):
            n = nlen[b]
            f = cellf[b, i, j]
            g1, g2 = gates(b, i, j, False)
            umax, vmax = i - 2, n - j - 1
            part = np.zeros((len(e), 32), f32)
            for c in range(4):
                t = np.arange(beg[c], beg[c + 1])
                u, v = su[t][None, :], sv[t][None, :]
                ok = (u <= umax[:, None]) & (v <= vmax[:, None])
                p = np.clip(i[:, None] - 1 - u, 0, lp - 1)
                dq = np.minimum(d + 2 + u + v, lp - 1)   # read only where ok
                x = np.where(ok, clc[b[:, None], dq, p, c], f32(0))
                x = x * (g1[:, u[0]] & g2[:, v[0]]).astype(f32)
                part = part + _lanes(K[b[:, None], t[None, :]] * x) * f[:, c][:, None]
            rt = (code[b, i, j] >> 3) & 7
            si1, si2, sj1, sj2 = (Sx(b, i - 1), Sx(b, i - 2), Sx(b, j + 1), Sx(b, j + 2))
            for k, (u, v) in enumerate(mcu.SPECIAL):
                ok = (u <= umax) & (v <= vmax)
                p, q_ = np.maximum(i - 1 - u, 0), np.minimum(j + 1 + v, lp - 1)
                clv = cl[b, q_ - p, p]
                tpo = code[b, p, q_] & 7
                sb = scs[b]
                if k == 0:
                    term = clv * tb[o_st + tpo * 8 + rt] * sb[:, 0]
                elif k in (1, 2):
                    term = clv * tb[o_b1] * tb[o_st + tpo * 8 + rt] * sb[:, 1]
                elif k == 3:
                    term = clv * tb[o_11 + ((tpo * 8 + rt) * 5 + si1) * 5 + sj1] * sb[:, 2]
                elif k == 4:
                    term = clv * tb[o_21 + (((tpo * 8 + rt) * 5 + si1) * 5 + sj1) * 5 + sj2] \
                        * sb[:, 3]
                elif k == 5:
                    term = clv * tb[o_21 + (((rt * 8 + tpo) * 5 + sj1) * 5 + si2) * 5 + si1] \
                        * sb[:, 3]
                else:
                    term = clv * tb[o_22 + ((((tpo * 8 + rt) * 5 + si2) * 5 + si1) * 5 + sj1) * 5
                                    + sj2] * sb[:, 4]
                add = term * (g1[:, u] & g2[:, v]).astype(f32)
                part[:, k] = np.where(ok, part[:, k] + add, part[:, k])
            width = int((n - j).max())
            ll = j[:, None] + 1 + np.arange(width)[None, :]
            okl = ll <= n[:, None]
            llc = np.minimum(ll, lp - 1)
            b_, i_, j_ = b[:, None], i[:, None], j[:, None]
            av, bv = a1[b_, i_, llc], a2[b_, i_, llc]
            ml = np.where(okl, (av + bv) * qm[b_, j_ + 1, llc - 1]
                          + av * bs_seg[b_, j_ + 1, llc - 1], f32(0))
            w_int = _butterfly(part)
            ml = _butterfly(_lanes(ml))
            w_ext = q1[b, i - 1] * qn[b, j + 1] * f[:, 11] / q[b]
            qb = qbl[b, d, i]
            pv = qb * ((w_ext + w_int) + ml * f[:, 9])
            pout[b, i, j] = pv
            cint = pv / np.where(qb > 0, qb, f32(1))
            cl[b, d, i] = cint
            clc[b, d, i] = cint[:, None] * f[:, 4:8]
            cm[b, d, i] = cint * f[:, 10] * sc[b] * sc[b]
        if d + 1 < maxn:   # diagonal d + 1's accumulator update
            e = pairs[pair_off[d + 1] : pair_off[d + 2]]
            b, k = e >> 16, e & 0xFFFF
            c = cm[b, d + 1, k]
            b, k, c = b[c != 0], k[c != 0], c[c != 0]
            ip = k[:, None] + 1 + np.arange(d)[None, :]
            b_, k_, c_ = b[:, None], k[:, None], c[:, None]
            l_ = k_ + d + 1
            a1[b_, ip, l_] = a1[b_, ip, l_] + c_ * qm[b_, k_ + 1, ip - 1]
            a2[b_, ip, l_] = a2[b_, ip, l_] + c_ * bs_seg[b_, k_ + 1, ip - 1]
    return pout, q


def _emulated(args, sc, codes, tabs):
    prep = mcu.prepare(*args, codes, tabs)
    pout, Q = emulate(mcu.pack(prep, sc))
    return torch.from_numpy(pout), torch.from_numpy(Q)


def _plain(args, sc, codes, tabs):
    return MK.mccaskill_fast(*args, sc, codes, tabs)


def _stable_sc(args, codes, tabs):
    """The ladder's last scale for the bucket, under the plain version (the
    padding rows, n = 1 and nothing unpaired, do not decide, as in
    `batch_bp_posteriors_fast`)."""
    B = args[0].shape[0]
    real = args[4].numpy() > 1
    sc = np.full(B, np.exp(-0.6), np.float32)
    for _ in range(16):
        pout, Q = _plain(args, torch.from_numpy(sc), codes, tabs)
        good, over = _reading(pout, Q)
        if good[real].all():
            return sc
        sc = np.where(good, sc, np.where(over, np.float32(sc * 0.8), np.float32(sc * 1.25)))
    raise AssertionError("no stable scale")


def _reading(pout, Q):
    """What the ladder reads of an attempt, per row: (good, over)."""
    Qv, pm = Q.numpy(), pout.numpy()
    good = np.isfinite(Qv) & (Qv > 1e-25) & (Qv < 1e25) & np.isfinite(pm).all(axis=(1, 2))
    return good, ~np.isfinite(Qv) | (Qv >= 1e25)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernels_match_plain(case):
    """At the ladder's last scale the transcription agrees with the plain
    version at the card's tolerance: pout rtol 2e-4 / atol 1e-6, Q rtol
    2e-4."""
    args, codes, tabs = _inputs(case)
    sc = torch.from_numpy(_stable_sc(args, codes, tabs))
    want_p, want_q = _plain(args, sc, codes, tabs)
    got_p, got_q = _emulated(args, sc, codes, tabs)
    np.testing.assert_allclose(got_q, want_q, rtol=2e-4, atol=0)
    np.testing.assert_allclose(got_p, want_p, **CARD)
    assert float(want_p.max()) > 0.3


def test_emulated_parts_match_plain():
    """qb, q1 and qn of the transcription against the plain version's, at
    rtol 2e-4 and a millionth of their largest value."""
    args, codes, tabs = _inputs("mixed")
    sc = torch.from_numpy(_stable_sc(args, codes, tabs))
    _, _, parts = MK.mccaskill_fast(*args, sc, codes, tabs, parts=True)
    pk = mcu.pack(mcu.prepare(*args, codes, tabs), sc)
    emulate(pk)
    t = pk["tensors"]
    Lp = t["qbl"].shape[1]
    d, i = np.meshgrid(np.arange(Lp), np.arange(Lp), indexing="ij")
    ok = i + d <= Lp - 1
    qb = np.zeros_like(parts["qb"].numpy())
    qb[:, i[ok], (i + d)[ok]] = t["qbl"].numpy()[:, d[ok], i[ok]]
    for got, want in ((qb, parts["qb"]), (t["q1"], parts["q1"]), (t["qn"], parts["qn"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6 * float(np.abs(want).max()))


def test_emulated_ladder_from_an_overflowing_scale():
    """From a scale at which Q overflows float32, the ladder takes the same
    attempts under the kernels' arithmetic as under the plain version:
    each attempt's scales and each row's reading (good, over) are the same,
    and the last agrees within the card's tolerance."""
    args, codes, tabs = _inputs("mixed")
    sc_ok = _stable_sc(args, codes, tabs)
    Q0 = _plain(args, torch.from_numpy(sc_ok), codes, tabs)[1].numpy()
    n = args[4].numpy()
    start = (sc_ok * (1e39 / Q0.astype(np.float64)) ** (1.0 / n)).astype(np.float32)
    runs = []
    for fold in (_plain, _emulated):
        sc, trace = start.copy(), []
        for _ in range(16):
            with np.errstate(over="ignore"):
                pout, Q = fold(args, torch.from_numpy(sc), codes, tabs)
            good, over = _reading(pout, Q)
            trace.append((sc.tolist(), good.tolist(), over.tolist()))
            if good.all():
                break
            sc = np.where(good, sc, np.where(over, np.float32(sc * 0.8), np.float32(sc * 1.25)))
        runs.append((pout, Q, trace))
    (want_p, want_q, plain), (got_p, got_q, kern) = runs
    assert not any(plain[0][1]) and all(plain[0][2]) and len(plain) > 1
    assert kern == plain
    np.testing.assert_allclose(got_q, want_q, rtol=2e-4, atol=0)
    np.testing.assert_allclose(got_p, want_p, **CARD)


@pytest.mark.parametrize("bl,constrained", [(True, False), (True, True), (False, False)])
def test_emulated_ladder_matches_jax(bl, constrained, monkeypatch):
    """The port's ladder with every attempt run by the transcription, against
    `dafs_tpu`'s batched fold (the overflowing sequence steps the scale)."""
    rng = np.random.default_rng(3)
    seqs = [OVERFLOW, _rna(rng, 50), _rna(rng, 66)]
    cons = None
    if constrained:
        cons = ["x" * 6 + "?" * 66, "((((" + "?" * 42 + "))))", "?" * 20 + "x" * 5 + "?" * 41]
    runs = []

    def attempt(args, sc, codes, tabs, prep=None):
        runs.append(float(sc[0]))
        return _emulated(args, sc, codes, tabs)

    monkeypatch.setattr(t_mc, "fold_attempt", attempt)
    got = t_mc.batch_bp_posteriors_fast(seqs, 0.0, "cpu", bl=bl, constraints=cons)
    want = j_mc.batch_bp_posteriors_fast(seqs, 0.0, bl=bl, constraints=cons)
    assert len(runs) > 1   # the overflowing sequence took a second attempt
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **JAX_TOL)
    assert got[0].max() > 0.5
    if constrained:
        # x unpaired; a forced pair's ends pair with nothing else
        assert not got[0][:6].any() and not got[0][:, :6].any() and not got[1][0, :-1].any()


def test_cpu_fold_launches_nothing(monkeypatch):
    """On the CPU the fold runs the plain version: no launcher is called, no
    count moves, the kernel library is not loaded."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA launcher was called for CPU tensors")

    kernels = (mcu.INSIDE, mcu.EXTERIOR, mcu.OUTSIDE)
    for k in kernels:
        monkeypatch.setattr(k, "_fn", (None, refuse))
    monkeypatch.setattr(mcu, "mccaskill", refuse)
    before = [k.launches for k in kernels]
    loaded = cuda_lib._LIB
    out = t_mc.batch_bp_posteriors_fast(["GGGAAAACCC", OVERFLOW], 0.0, "cpu")
    assert out[1].max() > 0.5
    assert [k.launches for k in kernels] == before
    assert cuda_lib._LIB is loaded


def test_wrapper_refuses_cpu_tensors():
    args, codes, tabs = _inputs("short")
    prep = mcu.prepare(*args, codes, tabs)
    with pytest.raises(ValueError, match="CUDA"):
        mcu.mccaskill(prep, torch.full((3,), 0.5))


def test_prepared_tables_index_back():
    """`prepare`'s per-cell factors are the plain version's (side_factors,
    exterior_factor, and the hairpin, stem and closing factors it forms a
    diagonal at a time); the code bytes hold pt, its reversed type and the
    allowed bit; the letters sit after SPAD zero columns; the blocked prefix
    and gates are the plain version's; the flat tables sit at their
    offsets."""
    args, codes, tabs = _inputs("constrained")
    S, pt, ap, au, n = args
    prep = mcu.prepare(*args, codes, tabs)
    t, I = prep["tensors"], prep["ints"]
    B, Lp = S.shape
    assert (I["nb"], I["lp"], I["maxn"]) == (B, Lp, int(n.max()))
    fac = MK.side_factors(S.long(), pt.long(), tabs)
    fac["ext"] = MK.exterior_factor(S.long(), pt.long(), n, tabs)
    for k, name in enumerate(mcu.FACTORS):
        if name in fac:
            assert torch.equal(t["cellf"][..., k], fac[name]), name
    # the hairpin, stem and closing factors as the plain version's diagonal
    # step forms them (sc ** (d + 1) left out)
    RT = torch.as_tensor(ep.RTYPE).long()
    Sl, ptl = S.long(), pt.long()
    blocked = MK.blocked_prefix(au, n)
    for d in range(1, Lp - 1):
        i = torch.arange(1, Lp - d)
        j = i + d
        tp = ptl[:, i, j]
        rt = RT[tp]
        si1, sim1, sj1 = Sl[:, i + 1], Sl[:, i - 1], Sl[:, j - 1]
        sjp1 = torch.where(j + 1 <= Lp - 1, Sl[:, (j + 1).clamp(max=Lp - 1)], 0)
        stem = tabs["mmM"][tp, sim1, sjp1] * MK.tau_factor(tp, tabs) * tabs["mli"]
        close = tabs["mmM"][rt, sj1, si1] * MK.tau_factor(rt, tabs) * tabs["mli"] * tabs["mlc"]
        assert torch.equal(t["cellf"][:, i, j, 9], stem), d
        assert torch.equal(t["cellf"][:, i, j, 10], close), d
        size = d - 1
        base = tabs["hairpin"][min(max(size, 0), MK.MAXLOOP)]
        if size > MK.MAXLOOP:
            base = base * tabs["lxc"] ** torch.log(torch.tensor(float(size)) / 30.0)
        mmh = tabs["mmH"][tp, si1, sj1]
        tri, tetra, hexa = (tabs[k][c.long()[:, i]] for k, c in zip(("tri", "tetra", "hexa"),
                                                                   codes))
        if size == 3:
            hp = torch.where(tri >= 0, tri, base * MK.tau_factor(tp, tabs))
        elif size == 4:
            hp = torch.where(tetra >= 0, tetra, base * mmh)
        elif size == 6:
            hp = torch.where(hexa >= 0, hexa, base * mmh)
        else:
            hp = base * mmh
        hp = torch.where((blocked[:, j - 1] - blocked[:, i] == 0) & (size >= 3), hp, 0.0)
        np.testing.assert_allclose(t["cellf"][:, i, j, 8], hp, rtol=2e-7, atol=0)
    assert torch.equal(t["code"].long() & 7, pt.long())
    assert torch.equal((t["code"].long() >> 3) & 7, RT[pt.long()])
    assert torch.equal((t["code"].long() >> 6) > 0, ap)
    assert torch.equal(t["seq"][:, mcu.SPAD : mcu.SPAD + Lp], S)
    assert not t["seq"][:, : mcu.SPAD].any() and not t["seq"][:, mcu.SPAD + Lp :].any()
    assert torch.equal(t["blk"].float(), blocked)
    assert torch.equal(t["gate_u"] > 0, au) and torch.equal(t["nlen"], n)
    off = 0
    for field, key in mcu.TABLES:
        want = tabs[key].reshape(-1)
        assert I[field] == off and torch.equal(t["tabs"][off : off + want.numel()], want)
        off += want.numel()
    assert I["o_bulge1"] == off and t["tabs"][off] == tabs["bulge"][1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_lists_are_the_allowed_cells(case):
    """Diagonal d's list is {(b, i): d > TURN, 1 <= i <= n_b - d, allowed},
    by b then i, for every d; the other cells of a diagonal are the ones
    the inside gives qm1 and qm only."""
    args, codes, tabs = _inputs(case)
    ap, n = args[2].numpy(), args[4].numpy()
    prep = mcu.prepare(*args, codes, tabs)
    pairs, off = prep["tensors"]["pairs"].tolist(), prep["tensors"]["pair_off"].tolist()
    maxn = prep["ints"]["maxn"]
    assert len(off) == maxn + 1 and off[0] == 0 and off[-1] == len(pairs)
    for d in range(maxn):
        want = [b << 16 | i for b in range(len(n)) for i in range(1, n[b] - d + 1)
                if d > MK.TURN and ap[b, i, i + d]]
        assert pairs[off[d] : off[d + 1]] == want, d
    assert len(pairs) == int(ap.sum()) > 0


def test_slots_cover_the_stencil():
    """The slots are every (u, v), u + v <= 30, but the seven special ones,
    each with the one category whose constant the plain version can take
    there (the other three are 0), in the kernels' order; `pack`'s
    constants are the plain contraction's C[u][s] * sc ** (s + 2)."""
    tabs = params.to_device(t_mc._fast_tabs(True), "cpu")
    slots = mcu.stencil_slots()
    assert len(slots) == 496 - 7
    assert {(u, v) for u, v, _ in slots} | set(mcu.SPECIAL) == \
        {(u, s - u) for s in range(MK.SW) for u in range(s + 1)}
    assert slots == sorted(slots, key=lambda c: (mcu.CATEGORIES.index(c[2]), c[0] + c[1], c[0]))
    for u, v, cat in slots:
        for other in mcu.CATEGORIES:
            if other != cat:
                assert tabs[f"C_{other}"][u, u + v] == 0, (u, v, other)
    for u, v in mcu.SPECIAL:
        assert all(tabs[f"C_{c}"][u, u + v] == 0 for c in mcu.CATEGORIES)
    covered = torch.zeros((MK.SW, MK.SW), dtype=torch.bool)
    for u, v, _ in slots:
        covered[u, u + v] = True
    for c in mcu.CATEGORIES:
        assert not tabs[f"C_{c}"][~covered].any(), c
    args, codes, _ = _inputs("short")
    prep = mcu.prepare(*args, codes, tabs)
    I = prep["ints"]
    cats = [c for _, _, c in slots]
    assert (I["s_1n"], I["s_23"], I["s_tau"]) == tuple(cats.index(c) for c in ("1n", "23", "tau"))
    assert [(s & 255, s >> 8) for s in prep["tensors"]["slots"].tolist()] == \
        [(u, v) for u, v, _ in slots]
    sc = torch.tensor([0.55, 0.7, 1.1])
    pk = mcu.pack(prep, sc)
    plain_pow = sc[:, None] ** (torch.arange(MK.SW).to(torch.float32) + 2.0)
    for t_, (u, v, c) in enumerate(slots):
        want = (tabs[f"C_{c}"][None] * plain_pow[:, None, :])[:, u, u + v]
        assert torch.equal(pk["tensors"]["kslot"][:, t_], want)
    bs = tabs["mlb"] * sc
    seg_len, seg_ok = MK.segments(MK.blocked_prefix(args[3], args[4]))
    assert torch.equal(pk["tensors"]["bs_seg"], MK.bs_segments(seg_len, seg_ok, bs))
    assert torch.equal(pk["tensors"]["scs"], plain_pow)
    for field, kind in mcu.STATE:   # zeroed, each on 64 bytes (float4 reads need 16)
        assert tuple(pk["tensors"][field].shape) == \
            mcu.shapes(I, 0, 0)[kind] and not pk["tensors"][field].any()
        assert (pk["tensors"][field].data_ptr() - pk["tensors"]["qbl"].data_ptr()) % 64 == 0


def test_struct_matches_the_source():
    """McArgs (ctypes) has csrc/mccaskill.cu's fields, in its order, with
    pointers where the source has pointers."""
    import ctypes

    with open(CU) as fh:
        src = fh.read()
    body = re.search(r"struct McArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        typ, names = re.match(r"((?:const )?\w+\*?)\s+(?:__restrict__\s+)?(.*)", decl,
                              re.S).groups()
        for nm in names.split(","):
            fields.append((nm.strip(), typ.endswith("*")))
    got = [(f, t is ctypes.c_void_p) for f, t in mcu.McArgs._fields_]
    assert got == fields
    enum = re.search(r"enum \{ (.*?) \};", src).group(1).split(", ")
    assert len(enum) == len(mcu.FACTORS) == 12
