"""The consensus's CUDA path on the CPU: what can be checked without a card.

The kernels of `csrc/alifold.cu` run only on the card (`tests/test_torch_cuda.py`
and `chip_smoke.py` hold them to the plain version there).  Here:

- `alifold_kernel.prepare` builds only what both routes read; the plain
  loops add their own shift tensors, and the steps are `inside_outside`
  bit for bit;
- `Alifold.consensus` on the CPU takes the plain loops and launches nothing;
- the arguments `alifold_cuda.pack` builds (the flat tables at their
  offsets, the diag-major planes, the records, codes and per-sequence
  vectors repacked once a call in their narrow dtypes, the compact list of
  pair-allowed cells, the stencil cells, the state buffers) index back to
  the prepared values, and the ctypes struct has the C struct's fields in
  its order;
- `emulate`, a numpy transcription of the three kernels that reads only the
  packed arguments, with the kernels' indexing, diagonal steps, cell lists
  and skips, agrees with the plain version at the tolerance the card's run
  is held to (rtol 2e-4; atol 1e-6 on pout, none on Q): bl True and False,
  a constrained call, BCUT 8, 16 and 31, two to four sequences; through
  the pf-scale ladder from a scale at which Q and the stencil's scale
  powers overflow, every attempt reads as the plain version's; and its B
  group cut to loop sizes <= 2 gives the bits of the uncut one.
"""

import os
import re

import numpy as np
import pytest
import torch

from dafs_tpu_torch.ops import alifold, alifold_cuda
from dafs_tpu_torch.ops import alifold_kernel as ak

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-6)
CU = os.path.join(os.path.dirname(ak.__file__), os.pardir, "csrc", "alifold.cu")

CASES = {
    "gapped": (["GGGC-AAAGCCC", "GG-CAAA-GCCC", "GGGCAA--GCCC"], True, None, None),
    "vienna": (["GGGC-AAAGCCC", "GG-CAAA-GCCC", "GGGCAA--GCCC"], False, None, None),
    "constrained": (["GGGC-AAAGCCC", "GG-CAAA-GCCC"], True, "(((x....x)))", None),
    "bcut8": (["GGGCAACGACGG--UUCGUCG--AAACCC", "GGGCAACG--GGCAUUCG--GCAAACCC-",
               "GGGCA--GACGGCAUU--UCGGCAAACC-"], True, None, None),
    "bcut31": (["GGGCAACGACGG--UUCGUCG--AAACCC", "GGGCAACG--GGCAUUCG--GCAAACCC-",
                "GGGCA--GACGGCAUU--UCGGCAAACC-"], True, None, 31),
    "bcut16": (["GGGGAAAAAAAAAAAACCCC----", "GGGG------------AAAACCCC"], True, None, None),
    "four": (["GCGCUUCGGCGCAAAGG", "GCGC-UCGGCGCAAAGG", "GCACUUCGGUGCAA-GG",
              "GCGCUUCGG-GCAAAGG"], False, None, None),
}


def _prepared(case, sc=alifold.SC0):
    seqs, bl, con, bcut = CASES[case]
    x = alifold._inputs(seqs, bl, con)
    BCUT = alifold._bcut(x["S"], x["n"])
    if bcut is not None:
        BCUT = max(BCUT, bcut)
    args = alifold.device_args(x, "cpu")
    return args, x, BCUT, ak.prepare(*args, x["n"], np.float32(sc), x["bsn0"])


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------------------ the kernels --
# A numpy transcription of csrc/alifold.cu: the same buffers, offsets and
# loops, one CTA's cell at a time, the stencil cells of a cell as one array.
# A scan's step is one diagonal: the inside's pair-allowed cells from the
# compact list, then its other cells' qm1 and qm; the outside's cells from
# the list and the accumulator update for the diagonal above; the grid
# barrier after each.  Within a step the kernels' CTAs touch disjoint
# entries, so the step's cells are taken one after another here.

def _ldo(I, p, q):
    return (ak.RP + q - p) * I["wc"] + ak.SW + 2 + p


def _a_group(o, U1, U2, full, uside, tgen, bu, f1n, c23):
    f32 = np.float32
    ind = lambda x, k: (x == k).astype(f32)  # noqa: E731
    tg = tgen[U1 * ak.SW + U2]
    iu0, iu1, iu2, iu3 = (ind(U1, k) for k in range(4))
    iv0, iv1, iv2, iv3 = (ind(U2, k) for k in range(4))
    t1n = iu1 * f1n[U2] + f1n[U1] * iv1
    t23 = c23 * (iu2 * iv3 + iu3 * iv2)
    tblg = iu0 * bu[U2] + bu[U1] * iv0
    k_full = o[0] * tg + o[1] * t1n + o[2] * t23 + o[3] * tblg
    k_part = o[0] * tg + np.where(uside, o[1] * (iu1 * f1n[U2]) + o[3] * (iu0 * bu[U2]), f32(0))
    k_part = np.where(uside, k_part, o[0] * tg)
    return np.where(full, k_full, k_part)


def _masks(U1, U2, blg1):
    f32 = np.float32
    iu = [(U1 == k).astype(f32) for k in range(3)]
    iv = [(U2 == k).astype(f32) for k in range(3)]
    sb = iu[0] * iv[0] + blg1 * (iu[0] * iv[1] + iu[1] * iv[0])
    return sb, iu[1] * iv[1], iu[1] * iv[2], iu[2] * iv[1], iu[2] * iv[2]


def emulate(pk, b_skip=True):
    """(pout (Lp, Lp), Q) of the three kernels on `pack`'s arguments.
    b_skip: the B group only where both loop sizes are <= 2, as the
    kernels; False evaluates it wherever v and u are below BCUT."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return _emulate(pk, b_skip)


def _emulate(pk, b_skip):
    f32 = np.float32
    t, I = pk["tensors"], pk["ints"]
    T = {k: v.numpy().reshape(-1).copy() for k, v in t.items()}
    ns, lp, n, wb, bcut = I["ns"], I["lp"], I["n"], I["wb"], I["bcut"]
    in_rec, out_rec = (t[k].numpy().reshape(-1, ns, 4) for k in ("in_rec", "out_rec"))
    codes = t["codes"].numpy().reshape(-1, len(alifold_cuda.CODES), ns).astype(np.int64)
    tb = T["tabs"]
    tgen = tb[I["o_tgen"] : I["o_tgen"] + ak.SW * ak.SW]
    bu, f1n = tb[I["o_bu"] : I["o_bu"] + ak.SW], tb[I["o_f1n"] : I["o_f1n"] + ak.SW]
    c23, blg1, sc, bsn = (tb[I[k]] for k in ("o_c23", "o_blg1", "o_sc", "o_bsn"))
    cu, cv = T["cells"] & 255, T["cells"] >> 8
    a2, s5, s3 = (T[k].astype(np.int64) for k in ("a2sb", "s5b", "s3b"))
    pairs, pair_off = T["pairs"], T["pair_off"]
    qbl, cl, cm, qm, qm1t, a1t, a2t = (T[k] for k in ("qbl", "cl", "cm", "qm", "qm1t", "a1t",
                                                      "a2t"))
    q1, qn, q, pout = T["q1"], T["qn"], T["q"], T["pout"]

    def product(i, j, off, inner):
        """The product over the sequences at the stencil cells whose
        partners sit at `off`."""
        u, v = cu[off[1]], cv[off[1]]
        off = off[0]
        full, uside = v < bcut, u < bcut
        kp = np.ones(len(u), f32)
        cij = _ldo(I, i, j)
        for s in range(ns):
            b = s * wb + ak.PAD
            if inner:   # inside: the stencil holds the inner pairs
                row, st = out_rec[cij, s], in_rec[off, s]
                U1 = np.maximum(0, a2[b + i + u] - a2[b + i])
                U2 = np.maximum(0, a2[b + j - 1] - a2[b + j - 1 - v])
                lu, lv = s5[b + i + 1 + u], s3[b + j - 1 - v]
            else:
                row, st = in_rec[cij, s], out_rec[off, s]
                U1 = np.maximum(0, a2[b + i - 1] - a2[b + i - 1 - u])
                U2 = np.maximum(0, a2[b + j + v] - a2[b + j])
                lu, lv = s3[b + i - 1 - u], s5[b + j + 1 + v]
            o = [row[c] * st[:, c] for c in range(4)]
            k = _a_group(o, U1, U2, full, uside, tgen, bu, f1n, c23)
            m_sb, m11, m12, m21, m22 = _masks(U1, U2, blg1)
            if inner:
                tp7, c175, c35 = codes[cij, :3, s]
                tp2 = codes[off, 3, s]
                m35, sp = tp2 * 5 + lv, lu
                bv = (tb[I["o_t7"] + tp7 * 7 + tp2] * m_sb
                      + tb[I["o_ti11"] + c175 * 7 + tp2] * m11
                      + tb[I["o_ti21a"] + c175 * 35 + m35] * m12
                      + (tb[I["o_ti21b"] + (c35 * 5 + sp) * 35 + m35] * m21
                         + tb[I["o_ti22"] + (c175 * 5 + sp) * 35 + m35] * m22))
            else:
                rt7, c175i, c35i = codes[cij, 3:, s]
                tpo = codes[off, 0, s]
                cout = tpo * 25 + lu * 5 + lv
                bv = (tb[I["o_t7"] + tpo * 7 + rt7] * m_sb
                      + (tb[I["o_ti11"] + cout * 7 + rt7] * m11
                         + tb[I["o_ti21a"] + cout * 35 + c35i] * m12
                         + tb[I["o_ti22_o"] + cout * 175 + c175i] * m22)
                      + tb[I["o_ti21b_o"] + (tpo * 5 + lu) * 175 + c175i] * m21)
            use = full & uside
            if b_skip:
                use = use & (U1 <= 2) & (U2 <= 2)
            k = np.where(use, k + bv, k).astype(f32)
            kp = (kp * k).astype(f32)
        return kp

    def stencil(i, j, inner, m_of):
        """The stencil sum: the active cells (m != 0) and the others'
        0 * SCP terms (gather_active, stencil_partial)."""
        if inner:
            off = _ldo(I, i + 1 + cu, j - 1 - cv)
        else:
            off = _ldo(I, i - 1 - cu, j + 1 + cv)
        m = m_of[off]
        act = np.nonzero(m != 0)[0]
        scp = T["scp"][cu * ak.SW + cv]
        terms = f32(0) * scp                                # NaN where scp is inf
        kp = product(i, j, (off[act], act), inner)
        if inner:
            terms[act] = m[act] * kp * scp[act]
        else:
            terms[act] = m[act] * (kp * T["psc"][off[act]]) * scp[act]
        return np.sum(terms, dtype=f32)

    def inside_rest(i, d, qb):
        j = i + d
        cij = _ldo(I, i, j)
        qm1t[j * lp + i] = qm1t[(j - 1) * lp + i] * bsn * T["gate_u"][j] + qb * T["mlstem"][cij]
        k = np.arange(i, j + 1)
        qm[i * lp + j] = np.sum((T["bs_seg"][i * lp + k - 1] + qm[i * lp + k - 1])
                                * qm1t[j * lp + k], dtype=f32)

    for d in range(1, n):                                   # dafs_alifold_inside
        for i in pairs[pair_off[d] : pair_off[d + 1]]:
            j = i + d
            cij = _ldo(I, i, j)
            interior = stencil(i, j, True, qbl)
            k = np.arange(i + 2, j)
            mlsum = np.sum(qm[(i + 1) * lp + k - 1] * qm1t[(j - 1) * lp + k], dtype=f32)
            hp = T["hp"][cij] * T["sc_pow"][d + 1]
            ml = mlsum * T["mlclose"][cij] * sc * sc
            qb = (hp + interior + ml) * T["psc"][cij]
            qbl[cij] = qb
            inside_rest(i, d, qb)
        for i in range(1, n - d + 1):
            if not (d > ak.TURN and T["ap"][_ldo(I, i, i + d)] > 0):
                inside_rest(i, d, f32(0))

    # dafs_alifold_exterior: each finished q1[k] (qn[m]) pushed into the
    # accumulators of the columns after (before) it, in that order
    cols = np.arange(lp)
    acc = np.zeros(lp, f32)
    q1[0] = 1
    for k in range(n):
        c = cols[(cols > k) & (cols <= n)]
        acc[c] = acc[c] + q1[k] * (qbl[_ldo(I, k + 1, c)] * T["ext"][(k + 1) * lp + c])
        q1[k + 1] = q1[k] * sc * T["gate_u"][k + 1] + acc[k + 1]
    q[0] = q1[n]
    acc = np.zeros(lp, f32)
    qn[n + 1] = 1
    for m in range(n + 1, 1, -1):
        c = cols[(cols >= 1) & (cols <= m - 1)]
        acc[c] = acc[c] + qbl[_ldo(I, c, m - 1)] * T["ext"][c * lp + m - 1] * qn[m]
        qn[m - 1] = qn[m] * sc * T["gate_u"][m - 1] + acc[m - 1]

    for d in range(n - 1, 0, -1):                           # dafs_alifold_outside
        for i in pairs[pair_off[d] : pair_off[d + 1]]:
            j = i + d
            cij = _ldo(I, i, j)
            w_int = stencil(i, j, False, cl)
            l = np.arange(j + 1, n + 1)
            a1, a2_ = a1t[l * lp + i], a2t[l * lp + i]
            mlsum = np.sum((a1 + a2_) * qm[(j + 1) * lp + l - 1]
                           + a1 * T["bs_seg"][(j + 1) * lp + l - 1], dtype=f32)
            w_ext = q1[i - 1] * qn[j + 1] * T["ext"][i * lp + j] / q[0]
            w_ml = mlsum * T["mlstem"][cij]
            qb = qbl[cij]
            p = qb * (w_ext + w_int + w_ml)
            pout[i * lp + j] = p
            clv = p / (qb if qb > 0 else f32(1))
            cl[cij] = clv
            cm[cij] = clv * T["psc"][cij] * T["mlclose"][cij] * sc * sc
        for k in range(1, n - d):                           # diagonal d + 1's update
            l = k + d + 1
            c = cm[_ldo(I, k, l)]
            ip = np.arange(k + 1, l)
            qv, bv = qm[(k + 1) * lp + ip - 1], T["bs_seg"][(k + 1) * lp + ip - 1]
            add = (c != 0) | ~np.isfinite(qv) | ~np.isfinite(bv)   # else an exact +0
            a1t[l * lp + ip[add]] += c * qv[add]
            a2t[l * lp + ip[add]] += c * bv[add]
    return pout.reshape(lp, lp), q[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernels_match_plain(case):
    _, x, BCUT, p = _prepared(case)
    pout, Q = ak.inside_outside(p, x["n"], BCUT=BCUT)
    got, gQ = emulate(alifold_cuda.pack(p, x["n"], BCUT))
    np.testing.assert_allclose(gQ, Q.numpy(), rtol=2e-4, atol=0)
    np.testing.assert_allclose(got, pout.numpy(), **TOL)
    assert pout.max() > 0.05 * Q


def _emulated(p, n, BCUT):
    pout, Q = emulate(alifold_cuda.pack(p, n, BCUT))
    return torch.from_numpy(pout), torch.tensor(Q)


def _traced(loops, trace):
    def run(p, n, BCUT):
        pout, Q = loops(p, n, BCUT=BCUT)
        trace.append((float(p["sc_t"]), float(Q), bool(torch.isfinite(pout).all()),
                      bool(torch.isfinite(p["SCP"]).all())))
        return pout, Q
    return run


@pytest.mark.parametrize("case", ["bcut8", "four"])
def test_emulated_ladder_from_an_overflowing_scale(case):
    """From a scale at which Q overflows float32 (and the stencil's scale
    powers sc ** (u + v + 2) with it), the ladder steps down through the
    same attempts under the kernels' arithmetic as under the plain loops:
    each attempt's scale, and whether Q and pout are finite, are the same,
    and the last agrees within the consensus tolerance."""
    args, x, BCUT, _ = _prepared(case)
    n = x["n"]
    _, Q0, sc0, _ = alifold.partition(args, n, x["bsn0"], alifold.SC0, BCUT, ak.inside_outside)
    start = np.float32(sc0 * np.float32((1e39 / Q0) ** (1.0 / n)))   # Q scales as sc ** n
    runs = []
    for loops in (ak.inside_outside, _emulated):
        trace = []
        with np.errstate(over="ignore"):
            out = alifold.partition(args, n, x["bsn0"], start, BCUT, _traced(loops, trace))
        runs.append((out, trace))
    (want, plain), (got, kern) = runs
    assert not np.isfinite(plain[0][1]) and not plain[0][3]   # Q and SCP overflowed
    assert len(plain) > 1 and [t[0] for t in kern] == [t[0] for t in plain]
    assert [(np.isfinite(t[1]), t[2]) for t in kern] == [(np.isfinite(t[1]), t[2]) for t in plain]
    assert got[2:] == want[2:]
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=0)
    np.testing.assert_allclose(got[0], want[0], **TOL)


PLAIN_ONLY = ("U1", "U1o", "SP1u", "SI1ou", "BU_u", "F1N_u", "IND_U", "BU_uo", "F1N_uo",
              "IND_UO", "V2J", "V2OJ", "SQ1J", "SJ1OJ", "BU_vJ", "F1N_vJ", "IND_VJ", "BU_vOJ",
              "F1N_vOJ", "IND_VOJ", "EXTL")


def test_prepare_builds_what_both_routes_read():
    """`prepare` builds every tensor `pack` hands the kernels and none of the
    plain loops' own shift tensors; the plain steps add those, and run
    one after another they are `inside_outside` bit for bit."""
    _, x, BCUT, p = _prepared("bcut8")
    read = ({nm for _, names, _, _ in alifold_cuda.INPUTS for nm in names}
            | {n for _, n in alifold_cuda.TABLES})
    assert read <= set(p) and not set(PLAIN_ONLY) & set(p)
    want_p, want_q = ak.inside_outside(p, x["n"], BCUT=BCUT)
    assert set(PLAIN_ONLY) <= set(p)
    p = _prepared("bcut8")[3]
    qb_mat, qm, _, QBL = ak.inside(p, x["n"], BCUT=BCUT)
    q1, qn, Q = ak.exterior(p, x["n"], qb_mat)
    pout = ak.outside(p, x["n"], QBL, qm, q1, qn, Q, BCUT=BCUT)
    assert _bits(pout, want_p) and _bits(Q, want_q)


def test_cpu_consensus_launches_no_kernel(monkeypatch):
    """On the CPU the consensus runs the plain loops; no launcher is
    called, and no count moves."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA launcher was called for CPU tensors")

    for k in (alifold_cuda.INSIDE, alifold_cuda.EXTERIOR, alifold_cuda.OUTSIDE):
        monkeypatch.setattr(k, "_fn", (None, refuse))
    before = [k.launches for k in (alifold_cuda.INSIDE, alifold_cuda.EXTERIOR,
                                   alifold_cuda.OUTSIDE)]
    ali = alifold.Alifold(0.0)
    pm = ali.consensus(CASES["gapped"][0], "cpu")
    assert pm.max() > 0.05 and ali.calls[0]["route"] == "alifold"
    assert [k.launches for k in (alifold_cuda.INSIDE, alifold_cuda.EXTERIOR,
                                 alifold_cuda.OUTSIDE)] == before


def test_wrapper_refuses_cpu_tensors():
    _, x, BCUT, p = _prepared("gapped")
    with pytest.raises(ValueError, match="CUDA"):
        alifold_cuda.inside_outside(p, x["n"], BCUT=BCUT)


def test_packed_tables_and_planes_index_back():
    """Every flat table at its offset holds the prepared table; the diag-
    major offset the kernels compute reads the plane's entry, a cell's
    record its sequences' four channels and its code bytes the six code
    planes; the per-sequence vectors sit after PAD columns, as bytes and
    shorts; the state is zero and of the struct's shapes."""
    _, x, BCUT, p = _prepared("bcut16")
    pk = alifold_cuda.pack(p, x["n"], BCUT)
    t, I = pk["tensors"], pk["ints"]
    assert I["bcut"] == BCUT == 16 and I["n"] == x["n"] and I["lp"] == x["L"] + 2
    for field, name in alifold_cuda.TABLES:
        want = p[name].reshape(-1)
        assert _bits(t["tabs"][I[field] : I[field] + want.numel()], want), name
    assert I["o_bsn"] + 1 == t["tabs"].numel()
    Lp, NS = p["Lp"], p["NS"]
    planes = alifold.device_args(x, "cpu")[0]
    for field, _, dtype, kind in alifold_cuda.INPUTS:
        assert t[field].dtype == dtype and tuple(t[field].shape) == \
            alifold_cuda.shapes(NS, Lp)[kind], field
    rng = np.random.default_rng(0)
    for _ in range(50):
        i, j = sorted(int(v) for v in rng.integers(0, Lp, 2))
        s, c = int(rng.integers(NS)), int(rng.integers(4))
        o = _ldo(I, i, j)
        r, col = ak.RP + j - i, ak.SW + 2 + i
        assert t["hp"].reshape(-1)[o] == planes["HP"][i, j]
        assert t["psc"].reshape(-1)[o] == p["PSCL"].reshape(-1)[o]
        name = ("MMI_IN", "MM1N_IN", "MM23_IN", "TAU_IN")[c]
        assert t["in_rec"].reshape(-1, NS, 4)[o, s, c] == planes[name][s, i, j]
        name = ("MMI_OUT", "MM1N_OUT", "MM23_OUT", "TAU_OUT")[c]
        assert t["out_rec"][r, col, s, c] == planes[name][s, i, j]
        for slot, name in enumerate(("TP7", "C175_OUT", "C35_OUT", "RT7", "C175_IN", "C35_IN")):
            assert int(t["codes"].reshape(-1, 6, NS)[o, slot, s]) == planes[name][s, i, j], name
        assert int(t["a2sb"][s, ak.PAD + i]) == x["a2s"][s, i]
        assert int(t["s5b"][s, ak.PAD + j]) == x["S5"][s, j]
        assert int(t["s3b"][s, ak.PAD + i]) == x["S3"][s, i]
    # outside the matrix every diag-major buffer reads zero: the padding
    # rows and columns, and the body's entries past column Lp - 1
    C0 = ak.SW + 2
    body = torch.zeros((I["nrows"], I["wc"]), dtype=torch.bool)
    dd, ii = torch.meshgrid(torch.arange(Lp), torch.arange(Lp), indexing="ij")
    body[ak.RP : ak.RP + Lp, C0 : C0 + Lp] = ii + dd <= Lp - 1
    for field, _, _, kind in alifold_cuda.INPUTS:
        if kind in ("rec", "codes", "ld"):
            assert not t[field].reshape(I["nrows"], I["wc"], -1)[~body].any(), field
    for field, kind in alifold_cuda.STATE:
        assert tuple(t[field].shape) == alifold_cuda.shapes(NS, Lp)[kind]
        assert not t[field].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_repacked_inputs_index_back(case):
    """The repacked records, codes and per-sequence vectors hold
    `prepare`'s planes and vectors exactly, value for value (the narrow
    dtypes lose nothing); a second attempt's `pack` reuses them."""
    _, x, BCUT, p = _prepared(case)
    n, NS = x["n"], p["NS"]
    call = alifold_cuda.call_inputs(p, n)
    rec = call["in_rec"].permute(3, 2, 0, 1).reshape(p["IN_ST"].shape)
    assert _bits(rec.contiguous(), p["IN_ST"])
    rec = call["out_rec"].permute(3, 2, 0, 1).reshape(p["OUT_ST"].shape)
    assert _bits(rec.contiguous(), p["OUT_ST"])
    for slot, name in enumerate(alifold_cuda.CODES):
        assert torch.equal(call["codes"][:, :, slot, :].permute(2, 0, 1).long(), p[name]), name
    for field, name in (("s5b", "S5b"), ("s3b", "S3b"), ("a2sb", "A2Sb")):
        assert torch.equal(call[field].long(), p[name]), field
    assert NS == call["in_rec"].shape[2]
    pk = alifold_cuda.pack(p, n, BCUT, call)
    assert all(pk["tensors"][f] is call[f] for f in alifold_cuda.CALL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_lists_are_the_allowed_cells(case):
    """Diagonal d's compact list is {i : d > TURN, 1 <= i <= n - d, ap[i][i
    + d] > 0}, i ascending, for every d; the other cells are the ones the
    inside's second loop gives qm1 and qm only."""
    _, x, BCUT, p = _prepared(case)
    n = x["n"]
    pk = alifold_cuda.pack(p, n, BCUT)
    pairs, off = pk["tensors"]["pairs"].tolist(), pk["tensors"]["pair_off"].tolist()
    assert len(off) == n + 1 and off[0] == 0 and off[-1] == len(pairs)
    ap = x["allow_pair"]
    for d in range(n):
        want = [i for i in range(1, n - d + 1) if d > ak.TURN and ap[i, i + d]]
        assert pairs[off[d] : off[d + 1]] == want, d
    assert len(pairs) == int(ap.sum()) > 0


@pytest.mark.parametrize("case", ["bcut8", "bcut31", "four"])
def test_emulated_b_group_skip_is_bitwise_invisible(case):
    """The B group evaluated only where both loop sizes are <= 2 gives the
    bits of the B group evaluated on the whole BCUT corner: elsewhere every
    mask, m.sb's blg1 term included, is 0 and the lookups are finite."""
    _, x, BCUT, p = _prepared(case)
    pk = alifold_cuda.pack(p, x["n"], BCUT)
    skip, full = emulate(pk), emulate(pk, b_skip=False)
    assert np.array_equal(skip[0].view(np.int32), full[0].view(np.int32))
    assert skip[1].view(np.int32) == full[1].view(np.int32)


def test_stencil_cells_are_the_stair_blocks():
    cells = alifold_cuda.stencil_cells()
    want = {(u, v) for v0, v1, u_ext in ak.STAIR for v in range(v0, v1) for u in range(u_ext)}
    assert len(cells) == len(want) == 601 and set(cells) == want
    assert cells == sorted(cells, key=lambda c: (c[0] + c[1], c[0]))
    _, x, BCUT, p = _prepared("gapped")
    packed = alifold_cuda.pack(p, x["n"], BCUT)["tensors"]["cells"].tolist()
    assert [(c & 255, c >> 8) for c in packed] == cells


def test_struct_matches_the_source():
    """AlifoldArgs (ctypes) has csrc/alifold.cu's fields, in its order, with
    pointers where the source has pointers."""
    with open(CU) as fh:
        src = fh.read()
    body = re.search(r"struct AlifoldArgs \{(.*?)\n\};", src, re.S).group(1)
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
    got = [(f, t is __import__("ctypes").c_void_p) for f, t in alifold_cuda.AlifoldArgs._fields_]
    assert got == fields
