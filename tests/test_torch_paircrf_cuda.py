"""The pair-CRF kernels' surroundings on the CPU: what can be checked without
a card.

The kernels of `csrc/paircrf.cu` run only on the card (`tests/test_torch_cuda.py`
and `chip_smoke.py` hold them to the plain version there, bit for bit).  Here:

- a CPU tensor takes the plain version, and the kernels' wrappers refuse
  CPU tensors and launch nothing;
- every exported launcher takes the pointers and ints its `CudaKernel`
  declares, in that order, then the stream;
- the float32 constants of the source's Fast_LogPlusEquals and Fast_Exp are
  those of `ops/logspace.py`;
- `emulate`, a numpy transcription of the three kernels (rows as lanes,
  warps of `ws` rows walking the diagonals in step, the hand-over slots
  between warps, the strips above a block's rows, the cell functions with
  the source's own constants, uninitialised memory as NaN), gives the
  plain version's bits on ragged batches, at warp and strip sizes small
  enough to cross many of them.
"""

import os
import re

import numpy as np
import pytest
import torch

from dafs_tpu_torch.ops import cuda_lib, logspace, paircrf, paircrf_cuda
from tests import card_checks

torch.set_num_threads(1)

CU = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc", "paircrf.cu")
F32 = np.float32
HEX = re.compile(r"-?0x[0-9a-f]+(?:\.[0-9a-f]*)?p[+-]\d+f")


def _source():
    with open(CU) as fh:
        return fh.read()


def _body(name):
    """The literals of the device function `name`, in source order."""
    src = _source()
    start = src.index(f"float {name}(float x) {{")
    return [F32(float.fromhex(h[:-1])) for h in HEX.findall(src[start: src.index("\n}\n", start)])]


def _f32(xs):
    return [F32(x) for x in xs]


def test_constants_match_logspace():
    lepo = _body("contra_lepo")
    uppers = [u for _, u in logspace.LEPO_PIECES[:-1]]
    coeffs = np.array([c for c, _ in logspace.LEPO_PIECES], dtype=np.float32)
    assert lepo[:7] == _f32(uppers)
    assert lepo[7:] == list(coeffs.T.reshape(-1))
    fexp = _body("contra_fast_exp")
    assert fexp[:5] == _f32(lower for _, lower in logspace.FEXP_PIECES[1:])
    coeffs = np.array([c for c, _ in logspace.FEXP_PIECES], dtype=np.float32)
    assert fexp[5:29] == list(coeffs.T.reshape(-1))
    assert fexp[29:] == _f32([46.052, 1e20, logspace.FEXP_PIECES[0][1]])
    src = _source()
    for name, value in (("NEG", logspace.NEG_INF), ("kHalfNeg", -1e20),
                        ("kLepoMax", logspace.CONTRA_LEPO_MAX)):
        (lit,) = re.findall(rf"constexpr float {name} = ({HEX.pattern});", src)
        assert F32(float.fromhex(lit[:-1])) == F32(value)


def test_launchers_match_their_argtypes():
    """Each `extern "C"` launcher's parameters (pointer or int, before the
    stream) are its `CudaKernel`'s argtypes: ctypes would pass a mismatch
    through unchecked."""
    src = _source()
    kernels = [paircrf_cuda.FORWARD, paircrf_cuda.BACKWARD, paircrf_cuda.POSTERIOR,
               paircrf_cuda.FLOOR_PROBE]
    found = re.findall(r'extern "C" int (dafs_paircrf_\w+)\(([^)]*)\)', src)
    assert sorted(name for name, _ in found) == sorted(k.symbol for k in kernels)
    params = dict(found)
    for k in kernels:
        args = [a.strip() for a in params[k.symbol].split(",")]
        assert args[-1] == "cudaStream_t stream"
        kinds = ["p" if "*" in a else "i" for a in args[:-1]]
        want = ["p" if t is paircrf_cuda._P else "i" for t in k.argtypes]
        assert kinds == want, k.symbol


def _rna(rng, lens, alphabet="ACGU"):
    return ["".join(rng.choice(list(alphabet), size=int(n))) for n in lens]


def _inputs(seqs1, seqs2, l1max=None, l2max=None):
    return card_checks.paircrf_inputs(seqs1, seqs2, "cpu", l1max, l2max)


def test_cpu_takes_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(0)
    args = _inputs(_rna(rng, (5, 40)), _rna(rng, (33, 7)))
    tab = paircrf.tables("cpu")
    kernels = [paircrf_cuda.FORWARD, paircrf_cuda.BACKWARD, paircrf_cuda.POSTERIOR]
    before = [k.launches for k in kernels]
    got = paircrf.forward_backward_posterior(*args, tab)
    assert torch.equal(got, paircrf.forward_backward_posterior_plain(*args, tab))
    assert [k.launches for k in kernels] == before
    for fn in (paircrf_cuda.forward, paircrf_cuda.backward,
               paircrf_cuda.forward_backward_posterior):
        with pytest.raises(ValueError, match="expected CUDA"):
            fn(*args, tab)
    with pytest.raises(ValueError, match="expected CUDA"):
        paircrf_cuda.posterior(torch.zeros((2, 5, 65, 65)), torch.zeros((2, 65, 65)),
                               *args, tab)
    assert [k.launches for k in kernels] == before


# ---------------------------------------------------------------- emulate --

NEG = F32(logspace.NEG_INF)
M_, IX, IY, I2X, I2Y = range(5)


class _Poly:
    """The source's compare-and-select cubic: the first piece whose bound
    exceeds x (`bounds`), its four coefficients, one Horner evaluation."""

    def __init__(self, lits, npieces):
        nb = npieces - 1
        self.bounds = lits[:nb]
        self.coeffs = [lits[nb + k * npieces: nb + (k + 1) * npieces] for k in range(4)]

    def __call__(self, x):
        piece = np.full(x.shape, len(self.bounds), dtype=np.int64)
        for k in reversed(range(len(self.bounds))):
            piece = np.where(x < self.bounds[k], k, piece)
        a, b, c, d = (np.asarray(cs, dtype=np.float32)[piece] for cs in self.coeffs)
        return ((a * x + b) * x + c) * x + d


class _Kernels:
    def __init__(self):
        lepo, fexp = _body("contra_lepo"), _body("contra_fast_exp")
        self.lepo = _Poly(lepo, 8)
        self.fexp_poly = _Poly(fexp[:29], 6)
        self.fexp_big, self.fexp_huge, self.fexp_zero = fexp[29:]
        self.half = F32(-1e20)
        self.lmax = F32(logspace.CONTRA_LEPO_MAX)

    def lse(self, x, y):
        hi, lo = np.maximum(x, y), np.minimum(x, y)
        d = hi - lo
        approx = self.lepo(np.minimum(d, self.lmax)) + lo
        return np.where((lo <= self.half) | (d >= self.lmax), hi, approx)

    def fast_exp(self, x):
        above = np.where(x > self.fexp_big, self.fexp_huge, np.exp(x))
        return np.where(x < self.fexp_zero, F32(0), np.where(x < 0, self.fexp_poly(x), above))


def _np_tables(tab):
    t = {k: v.numpy() for k, v in tab.items()}
    t["me"] = t["match"] + t["single"][M_]
    return t


def _where(cond, x, y):
    return np.where(cond, x, y).astype(np.float32)


def _forward_cell(K, T, c1, i, j, n1, n2, me_d, ey_d, p, q, s):
    """forward_cell of csrc/paircrf.cu over a vector of rows."""
    P, single = T["pair"], T["single"]
    EX = T["ins"][c1]
    valid = (i <= n1) & (j >= 0) & (j <= n2)
    not_first = (i > 1) | (j > 1)
    pr = _where((i == 1) & (j == 1), F32(0), F32(1))
    m = p[M_] + (me_d + pr * P[M_, M_])
    for k in (IX, IY, I2X, I2Y):
        m = _where(not_first, K.lse(m, p[k] + (me_d + P[k, M_])), m)
    m = _where(valid & (i > 0) & (j > 0), m, NEG)
    prx = _where((i == 1) & (j == 0), F32(0), F32(1))
    sX, s2X = single[IX], single[I2X]
    x = K.lse(K.lse(q[M_] + (EX + (sX + P[M_, IX])), q[IX] + (EX + (sX + P[IX, IX]))),
              q[IY] + (EX + (sX + P[IY, IX])))
    x2 = K.lse(K.lse(q[M_] + (EX + (s2X + P[M_, I2X])), q[I2X] + (EX + (s2X + P[I2X, I2X]))),
               q[I2Y] + (EX + (s2X + P[I2Y, I2X])))
    x = _where(j > 0, x, q[IX] + ((EX + sX) + prx * P[IX, IX]))
    x2 = _where(j > 0, x2, q[I2X] + ((EX + s2X) + prx * P[I2X, I2X]))
    x, x2 = (_where(valid & (i > 0), v, NEG) for v in (x, x2))
    pry = _where((i == 0) & (j == 1), F32(0), F32(1))
    ey1, ey2 = ey_d + single[IY], ey_d + single[I2Y]
    y = K.lse(K.lse(s[M_] + (ey1 + P[M_, IY]), s[IX] + (ey1 + P[IX, IY])),
              s[IY] + (ey1 + P[IY, IY]))
    y2 = K.lse(K.lse(s[M_] + (ey2 + P[M_, I2Y]), s[I2X] + (ey2 + P[I2X, I2Y])),
               s[I2Y] + (ey2 + P[I2Y, I2Y]))
    y = _where(i > 0, y, s[IY] + (ey1 + pry * P[IY, IY]))
    y2 = _where(i > 0, y2, s[I2Y] + (ey2 + pry * P[I2Y, I2Y]))
    y, y2 = (_where(valid & (j > 0), v, NEG) for v in (y, y2))
    out = np.stack([m, x, y, x2, y2])
    out = _where(((i == 0) & (j == 0))[None], F32(0), out)
    return _where(valid[None], out, NEG), valid


def _backward_cell(K, T, c1n, i, j, n1, n2, me_n, ey_n, dX, dX2, nM2, s):
    """backward_cell of csrc/paircrf.cu over a vector of rows."""
    P, single = T["pair"], T["single"]
    EXn = T["ins"][c1n]
    sX, s2X = single[IX], single[I2X]
    valid = (i <= n1) & (j >= 0) & (j <= n2)
    g00 = _where((i == 0) & (j == 0), F32(0), F32(1))
    has_m = (i < n1) & (j < n2)
    has_m_nf = has_m & ((i + 1 > 1) | (j + 1 > 1))
    has_x, has_y = i < n1, j < n2
    x_in, y_in = has_x & (j != 0), has_y & (i != 0)
    ey1n, ey2n = ey_n + single[IY], ey_n + single[I2Y]
    mterm = nM2 + me_n
    bM = _where(has_m, np.maximum(NEG, mterm + g00 * P[M_, M_]), NEG)
    bX, bY, bX2, bY2 = (_where(has_m_nf, np.maximum(NEG, mterm + P[k, M_]), NEG)
                        for k in (IX, IY, I2X, I2Y))

    def lpe(acc, v, cond):
        return _where(cond, K.lse(acc, v), acc)

    bM = lpe(bM, dX + (EXn + (sX + P[M_, IX])), x_in)
    bX = lpe(bX, dX + ((EXn + sX) + g00 * P[IX, IX]), has_x)
    bY = lpe(bY, dX + (EXn + (sX + P[IY, IX])), x_in)
    bM = lpe(bM, dX2 + (EXn + (s2X + P[M_, I2X])), x_in)
    bX2 = lpe(bX2, dX2 + ((EXn + s2X) + g00 * P[I2X, I2X]), has_x)
    bY2 = lpe(bY2, dX2 + (EXn + (s2X + P[I2Y, I2X])), x_in)
    bM = lpe(bM, s[IY] + (ey1n + P[M_, IY]), y_in)
    bX = lpe(bX, s[IY] + (ey1n + P[IX, IY]), y_in)
    bY = lpe(bY, s[IY] + (ey1n + g00 * P[IY, IY]), has_y)
    bM = lpe(bM, s[I2Y] + (ey2n + P[M_, I2Y]), y_in)
    bX2 = lpe(bX2, s[I2Y] + (ey2n + P[I2X, I2Y]), y_in)
    bY2 = lpe(bY2, s[I2Y] + (ey2n + g00 * P[I2Y, I2Y]), has_y)
    out = np.stack([bM, bX, bY, bX2, bY2])
    out = _where(((i == n1) & (j == n2))[None], F32(0), out)
    return _where(valid[None], out, NEG), valid


def _emulate_pass(K, T, forward, c1, c2, n1, n2, imax, l2max, ws, R):
    """One pass of one pair: strips of R rows (several when imax > R),
    warps of ws rows in each, a row a lane.  Returns the stored planes, NaN
    where the pass writes nothing."""
    W = l2max + 1
    out = np.full((5 if forward else 1, imax, W), np.nan, dtype=np.float32)
    E = np.full((2, W, 5), np.nan, dtype=np.float32)  # the strips' hand-over rows
    nw = R // ws
    code1 = np.append(c1, 4)
    starts = list(range(0, n1 + 1, R))
    for row0 in (starts if forward else starts[::-1]):
        strip = row0 // R
        Ein, Eout = E[(strip + 1) & 1], E[strip & 1]
        rows = row0 + np.arange(R)
        w, lane = (rows - row0) // ws, (rows - row0) % ws
        rb = row0 + ws * w
        rl = rb + ws - 1
        live = rb <= n1
        de = np.minimum(rl, n1) + n2
        next_live = rl < n1
        last_warp = w == nw - 1
        slots = np.full((nw, 2, 5), np.nan, dtype=np.float32)
        s = np.full((5, R), NEG, dtype=np.float32)
        p = np.full((5, R), NEG, dtype=np.float32)
        nM2 = np.full(R, NEG, dtype=np.float32)
        dlast = min(row0 + R - 1, n1) + n2
        diags = range(row0, dlast + 1) if forward else range(dlast, row0 - 1, -1)
        for d in diags:
            act = live & (d >= rb) & (d <= de)
            j = d - rows
            if forward:
                cj = c2[np.clip(j, 0, l2max)]
                me, ey = T["me"][code1[np.minimum(rows, imax)], cj], T["ins"][cj]
                q = np.concatenate([np.full((5, 1), np.nan, np.float32), s[:, :-1]], axis=1)
                first = lane == 0
                has = first & (d <= rb + n2)
                from_slot = has & (w > 0)
                from_e = has & (w == 0) & (row0 > 0)
                for r in np.flatnonzero(first & act):
                    q[:, r] = (slots[w[r] - 1, (d - 1) & 1] if from_slot[r]
                               else Ein[d - rb[r]] if from_e[r] else NEG)
                new, valid = _forward_cell(K, T, code1[np.minimum(rows, imax)], rows, j, n1, n2,
                                           me, ey, p, q, s)
                p = _where(act[None], q, p)
            else:
                cjn = c2[np.clip(j + 1, 0, l2max)]
                c1n = code1[np.minimum(rows + 1, imax)]
                me, ey = T["me"][c1n, cjn], T["ins"][cjn]
                down = np.concatenate([s[:, 1:], np.full((5, 1), np.nan, np.float32)], axis=1)
                dM, dX, dX2 = down[M_].copy(), down[IX].copy(), down[I2X].copy()
                for r in np.flatnonzero((lane == ws - 1) & act):
                    if next_live[r] and rl[r] <= d <= rl[r] + n2:
                        v = Ein[d - rl[r]] if last_warp[r] else slots[w[r] + 1, (d + 1) & 1]
                        dM[r], dX[r], dX2[r] = v[M_], v[IX], v[I2X]
                    else:
                        dM[r] = dX[r] = dX2[r] = NEG
                new, valid = _backward_cell(K, T, c1n, rows, j, n1, n2, me, ey, dX, dX2, nM2, s)
                nM2 = _where(act, dM, nM2)
            s = _where(act[None], new, s)
            for r in np.flatnonzero(act & valid):
                out[:, rows[r], j[r]] = s[:, r] if forward else s[M_, r]
            for r in np.flatnonzero(act):
                if forward and lane[r] == ws - 1 and next_live[r] and d >= rl[r]:
                    if last_warp[r]:
                        Eout[d - rl[r]] = s[:, r]
                    else:
                        slots[w[r], d & 1] = s[:, r]
                if not forward and lane[r] == 0 and d <= rb[r] + n2:
                    if w[r] > 0:
                        slots[w[r], d & 1] = s[:, r]
                    elif row0 > 0:
                        Eout[d - rb[r]] = s[:, r]
    return out


def emulate(codes1, len1, codes2, len2, tab, ws=32, R=1024):
    """The three kernels on numpy float32: the forward and backward pass
    of each pair (strips of R rows when imax > R, else one strip), then the
    posterior kernel.  (B, l1max, l2max)."""
    with np.errstate(all="ignore"):  # the cubics overflow at NEG, unselected
        return _emulate(codes1, len1, codes2, len2, tab, ws, R)


def _emulate(codes1, len1, codes2, len2, tab, ws, R):
    K, T = _Kernels(), _np_tables(tab)
    c1s, c2s = codes1.numpy(), codes2.numpy()
    B, imax = c1s.shape
    l2max = c2s.shape[1] - 1
    R = min(R, -(-imax // ws) * ws) if imax <= R else R
    post = np.zeros((B, imax - 1, l2max), dtype=np.float32)
    for b in range(B):
        n1, n2 = min(int(len1[b]), imax - 1), min(int(len2[b]), l2max)
        F = _emulate_pass(K, T, True, c1s[b], c2s[b], n1, n2, imax, l2max, ws, R)
        Bm = _emulate_pass(K, T, False, c1s[b], c2s[b], n1, n2, imax, l2max, ws, R)[0]
        Z = F[0, n1, n2]
        for k in range(1, 5):
            Z = K.lse(Z, F[k, n1, n2])
        ii, jj = np.meshgrid(np.arange(1, n1 + 1), np.arange(1, n2 + 1), indexing="ij")
        me = T["me"][c1s[b][ii], c2s[b][jj]]
        prm = _where((ii == 1) & (jj == 1), F32(0), F32(1))
        not_first = (ii > 1) | (jj > 1)
        acc = np.zeros(ii.shape, dtype=np.float32)
        for k in range(5):
            sc = me + prm * T["pair"][k, M_]
            term = K.fast_exp(F[k, ii - 1, jj - 1] + sc + Bm[ii, jj] - Z)
            if k != M_:
                term = _where(not_first, term, F32(0))
            acc = acc + term
        post[b, : n1, : n2] = np.minimum(np.maximum(acc, F32(0)), F32(1))
    return torch.from_numpy(post)


@pytest.mark.parametrize("case", ["ragged", "one pair", "length 1 and unknown bases",
                                  "strips"])
def test_emulated_kernels_match_plain(case):
    """Warps of 8 rows (strips of 16 rows in "strips"), so that
    small pairs cross many hand-overs; ragged lengths at the warps' edges,
    lengths 0 and 1, l1max != l2max, unknown bases (code 4)."""
    rng = np.random.default_rng(["ragged", "one pair", "length 1 and unknown bases",
                                 "strips"].index(case))
    ws, R = 8, 1024
    if case == "ragged":
        args = _inputs(_rna(rng, (7, 8, 9, 16, 17, 1, 30)), _rna(rng, (30, 17, 16, 9, 8, 40, 1)))
    elif case == "one pair":
        args = _inputs(_rna(rng, (23,)), _rna(rng, (19,)))
    elif case == "length 1 and unknown bases":
        args = _inputs(_rna(rng, (1, 12, 1), "ACGUNT"), _rna(rng, (1, 1, 15), "ACGUNT"))
        args[1][0] = 0
    else:
        R = 16
        args = _inputs(_rna(rng, (40, 33, 15, 16, 17)), _rna(rng, (12, 20, 9, 30, 3)),
                       l1max=47, l2max=32)
    tab = paircrf.tables("cpu")
    want = paircrf.forward_backward_posterior_plain(*args, tab)
    got = emulate(*args, tab, ws=ws, R=R)
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)
