"""IPknot pseudoknotted structure decoder (src/ipknot.cpp:39-377).

A copy of `dafs_tpu/decoders_ip/ipknot.py`.  That module needs only numpy
and scipy, but importing anything of `dafs_tpu` runs its `__init__`, which
imports JAX, and the port must run where JAX is absent; so the port keeps
its own copy, unchanged apart from this docstring.

Pseudoknotted common secondary structure as an ILP over P bracket levels:
per-level pair variables for positive-scoring pairs, one-partner-per-base,
level-internal planarity, each level-t pair must cross a lower-level pair,
and stacking ("no isolated pairs") constraints.  The reference links
GLPK/Gurobi/CPLEX (src/ip.cpp); here the same ILP is solved with scipy's
HiGHS `milp` on the host.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.optimize import LinearConstraint, milp

LEFT = "([{<ABCDEFGHIJKLMNOPQRSTUVWXYZ"
RIGHT = ")]}>abcdefghijklmnopqrstuvwxyz"


def _highs_core():
    """The persistent-model HiGHS binding: the public `highspy` package when
    installed, else scipy's private vendored copy.  Raises ImportError when
    neither is available — callers degrade to the per-iteration `decode`
    path (scipy `milp`), which only needs the public scipy API."""
    try:
        import highspy as hs  # public package, stable API

        return hs
    except ImportError:
        pass
    from scipy.optimize._highspy import _core as hs  # scipy-private fallback

    return hs


def _build_rows(vars_, L, P, levelwise):
    """Constraint rows over a variable list (make_constraints,
    src/ipknot.cpp:139-248).  Returns (rows, lb, ub) with rows as
    [(var, coeff), ...].

    Note: the level-internal crossing rows are emitted in np.nonzero
    row-major order (one directed row per crossing pair), which differs from
    the historical inline a<b loop in decode(); the constraint SET is
    identical, but MILP tie-breaking among equally-optimal structures could
    in principle differ from pre-change decode outputs on degenerate
    instances (observed snapshots are byte-stable)."""
    by_level: list[list[tuple[int, int, int]]] = [[] for _ in range(P)]
    for k, (lv, i, j) in enumerate(vars_):
        by_level[lv].append((k, i, j))

    rows, lb, ub = [], [], []

    def add_row(coeffs, lo, hi):
        rows.append(coeffs)
        lb.append(lo)
        ub.append(hi)

    # constraint 1: each base pairs at most once across levels
    partners = [[] for _ in range(L)]
    for k, (lv, i, j) in enumerate(vars_):
        partners[i].append(k)
        partners[j].append(k)
    for i in range(L):
        if partners[i]:
            add_row([(k, 1.0) for k in partners[i]], -np.inf, 1.0)

    if levelwise:
        # constraint 2: level-internal planarity (crossing pairs exclusive)
        for lv in range(P):
            lvl = by_level[lv]
            if not lvl:
                continue
            ii = np.array([v[1] for v in lvl])
            jj = np.array([v[2] for v in lvl])
            cross = (ii[:, None] < ii[None, :]) & (ii[None, :] < jj[:, None]) \
                & (jj[:, None] < jj[None, :])
            for a, b in zip(*np.nonzero(cross)):
                add_row([(lvl[a][0], 1.0), (lvl[b][0], 1.0)], -np.inf, 1.0)

        # constraint 3: each level-lv pair must be crossed by some pair at
        # each lower level (src/ipknot.cpp:181-206)
        for lv in range(1, P):
            for (k, kk, ll) in by_level[lv]:
                for plv in range(lv):
                    coeffs = [(k, -1.0)]
                    for (k2, i, j) in by_level[plv]:
                        if (i < kk < j < ll) or (kk < i < ll < j):
                            coeffs.append((k2, 1.0))
                    add_row(coeffs, 0.0, np.inf)

    # stacking constraints: no isolated pairs (src/ipknot.cpp:209-246)
    for lv in range(P):
        lvl = by_level[lv]
        up = [[] for _ in range(L)]   # variables with right end at i
        down = [[] for _ in range(L)]  # variables with left end at i
        for (k, i, j) in lvl:
            down[i].append(k)
            up[j].append(k)
        for i in range(L):
            if up[i]:
                coeffs = [(k, -1.0) for k in up[i]]
                if i > 0:
                    coeffs += [(k, 1.0) for k in up[i - 1]]
                if i + 1 < L:
                    coeffs += [(k, 1.0) for k in up[i + 1]]
                add_row(coeffs, 0.0, np.inf)
            if down[i]:
                coeffs = [(k, -1.0) for k in down[i]]
                if i > 0:
                    coeffs += [(k, 1.0) for k in down[i - 1]]
                if i + 1 < L:
                    coeffs += [(k, 1.0) for k in down[i + 1]]
                add_row(coeffs, 0.0, np.inf)
    return rows, lb, ub


class IPknotModel:
    """Persistent IPknot ILP for the DD loop (src/dafs.cpp:1091-1093 with
    s_decoder_ = IPknot): across subgradient iterations only the multiplier
    matrix q changes, so the variable/constraint skeleton is built ONCE over
    a superset of columns and each iteration just updates objective
    coefficients and column bounds on a persistent HiGHS model, warm-started
    from the previous incumbent.

    Column superset: cells whose score w*(p-th[lv]) - q[i,j] can ever be
    positive — the base-positive cells plus (when `extra` is given) the
    consensus-candidate cells, the only cells where the DD update can drive
    q below 0 (q grows elsewhere, only shrinking scores).  Inactive columns
    are pinned to 0 via bounds, which is exactly equivalent to rebuilding
    the reference model without them: every constraint row restricted to the
    active columns coincides with the row the reference would build, and
    rows touching only pinned columns are vacuous."""

    def __init__(self, p, th, w, extra=None, levelwise=True):
        hs = _highs_core()  # raises ImportError -> caller falls back to decode()

        self._hs = hs
        f = np.float32
        self.p = np.asarray(p, np.float32)
        self.th = [f(t) for t in th]
        self.w = f(w)
        self.L = L = self.p.shape[0]
        P = len(th)
        self.levelwise = levelwise

        base = self.w * (self.p[None, :, :]
                         - np.asarray(self.th, np.float32)[:, None, None])
        iu = np.triu_indices(L, 1)
        mask = np.zeros((L, L), bool)
        mask[iu] = True
        sup = (base > 0.0) & mask[None, :, :]
        if extra is not None:
            sup |= np.asarray(extra, bool)[None, :, :] & mask[None, :, :]
        self._sup = sup
        self._mask = mask
        lv_a, i_a, j_a = np.nonzero(sup)
        order = np.lexsort((lv_a, -i_a, j_a))
        self.lv_a, self.i_a, self.j_a = lv_a[order], i_a[order], j_a[order]
        self.nv = nv = len(self.lv_a)
        self.vars_ = list(zip(self.lv_a.tolist(), self.i_a.tolist(),
                              self.j_a.tolist()))
        if nv == 0:
            return

        rows, lb, ub = _build_rows(self.vars_, L, P, levelwise)
        data, ri, ci = [], [], []
        for r, coeffs in enumerate(rows):
            for k, c in coeffs:
                ri.append(r)
                ci.append(k)
                data.append(c)
        A = sparse.csc_matrix((data, (ri, ci)), shape=(len(rows), nv))

        lp = hs.HighsLp()
        lp.num_col_ = nv
        lp.num_row_ = len(rows)
        lp.col_cost_ = np.zeros(nv)
        lp.col_lower_ = np.zeros(nv)
        lp.col_upper_ = np.ones(nv)
        lp.row_lower_ = np.asarray(lb)
        lp.row_upper_ = np.asarray(ub)
        lp.a_matrix_.format_ = hs.MatrixFormat.kColwise
        lp.a_matrix_.start_ = A.indptr.astype(np.int64)
        lp.a_matrix_.index_ = A.indices.astype(np.int64)
        lp.a_matrix_.value_ = A.data
        lp.integrality_ = [hs.HighsVarType.kInteger] * nv
        lp.sense_ = hs.ObjSense.kMinimize
        self.h = hs._Highs()
        self.h.setOptionValue("output_flag", False)
        # scipy's milp wrapper runs HiGHS with its default MIP options; keep
        # the identical configuration so this path scores like decode()
        self.h.passModel(lp)
        self._prev = None

    def solve(self, q=None):
        """Returns (ss, bracket_str, score) like decode(p, th, w=w, q=q)."""
        f = np.float32
        L, P = self.L, len(self.th)
        if self.nv == 0:
            return np.full(L, -1, dtype=np.int64), "." * L, 0.0
        hs = self._hs
        if q is None:
            wts = self.w * (self.p[self.i_a, self.j_a]
                            - np.asarray(self.th, f)[self.lv_a])
        else:
            qa = np.asarray(q, np.float32)
            wts = np.float32(
                self.w * (self.p[self.i_a, self.j_a]
                          - np.asarray(self.th, f)[self.lv_a])
                - qa[self.i_a, self.j_a]
            )
        active = wts > 0.0
        if q is not None and __debug__:
            # invariant backing the superset construction (class docstring):
            # the DD update drives q negative only at consensus-candidate
            # cells, so every positive-score cell must lie inside the column
            # superset — otherwise this solve would silently drop a variable
            # the reference model would carry.
            full = np.float32(
                self.w * (self.p[None, :, :]
                          - np.asarray(self.th, f)[:, None, None])
                - qa[None, :, :]
            )
            outside = (full > 0.0) & self._mask[None, :, :] & ~self._sup
            assert not outside.any(), (
                "IPknotModel: positive-score cell outside the column superset"
            )
        idx = np.arange(self.nv, dtype=np.int32)
        self.h.changeColsCost(self.nv, idx, np.where(active, -wts, 0.0).astype(np.float64))
        self.h.changeColsBounds(
            self.nv, idx, np.zeros(self.nv),
            active.astype(np.float64),
        )
        if self._prev is not None:
            # MIP start from the previous incumbent, minus deactivated cols;
            # HiGHS repairs/rejects infeasible starts, so this is only a hint
            sol = hs.HighsSolution()
            sol.col_value = np.where(active, self._prev, 0.0)
            self.h.setSolution(sol)
        self.h.run()
        status = self.h.getModelStatus()
        if status not in (hs.HighsModelStatus.kOptimal,):
            return np.full(L, -1, dtype=np.int64), "." * L, 0.0
        x = np.asarray(self.h.getSolution().col_value)
        self._prev = np.round(x)
        sel = x > 0.5
        score = float(np.dot(wts.astype(np.float64), sel))

        ss = np.full(L, -1, dtype=np.int64)
        plevel = np.full(L, -1, dtype=np.int64)
        for k in np.nonzero(sel)[0]:
            lv, i, j = self.vars_[k]
            ss[i] = j
            plevel[i] = plevel[j] = lv
        if not self.levelwise:
            plevel = decompose_plevel(ss)
        s = ["."] * L
        for i in range(L):
            j = ss[i]
            if j >= 0 and i < j and plevel[i] < len(LEFT):
                s[i] = LEFT[plevel[i]]
                s[j] = RIGHT[plevel[i]]
        return ss, "".join(s), score


def _variables(p: np.ndarray, th: list[float], w: float | None, q: np.ndarray | None):
    """Enumerate per-level variables with weights (make_objective,
    src/ipknot.cpp:81-136); returns (vars, weights) where vars[k] = (lv, i, j).

    Vectorized (this runs twice per DD iteration in --ipknot mode,
    src/dafs.cpp:1091-1092; the original Python triple loop was ~70% of the
    per-iteration decode cost).  The enumeration order of the reference loop
    nest — j ascending, i descending, lv ascending — is reproduced exactly
    via lexsort, and all score arithmetic stays float32."""
    L = p.shape[0]
    f = np.float32
    P = len(th)
    p32 = np.asarray(p, np.float32)
    # scores per level: (P, L, L) f32, same op order as the scalar loop
    ths = np.asarray([f(t) for t in th], np.float32)[:, None, None]
    if w is None:
        S = np.float32(p32[None, :, :] - ths)
    else:
        qa = np.float32(0.0) if q is None else np.asarray(q, np.float32)
        S = np.float32(f(w) * (p32[None, :, :] - ths) - qa)
    iu = np.triu_indices(L, 1)
    mask = np.zeros((L, L), bool)
    mask[iu] = True
    lv_a, i_a, j_a = np.nonzero((S > 0.0) & mask[None, :, :])
    if lv_a.size == 0:
        return [], []
    order = np.lexsort((lv_a, -i_a, j_a))  # primary j asc, then i desc, lv asc
    lv_a, i_a, j_a = lv_a[order], i_a[order], j_a[order]
    out = list(zip(lv_a.tolist(), i_a.tolist(), j_a.tolist()))
    wts = S[lv_a, i_a, j_a].astype(np.float64).tolist()
    return out, wts


def decompose_plevel(ss: np.ndarray) -> np.ndarray:
    """Re-derive bracket levels by greedy graph coloring (src/ipknot.cpp:295-356).

    Vertices are base pairs (indexed by left base); two pairs are adjacent iff
    they cross.  Vertices are colored greedily in descending-degree order with
    the smallest unused color, then colors are renumbered in descending order
    of pair count per color.  Only left-end positions receive a level (the
    reference leaves right ends at -1 after decomposition).
    """
    L = len(ss)
    g: list[list[int]] = [[] for _ in range(L)]
    for i in range(L):
        j = int(ss[i])
        if j < 0 or j <= i:
            continue
        for k in range(i + 1, L):
            l = int(ss[k])
            if l < 0 or l <= k:
                continue
            if k < j < l:
                g[i].append(k)
                g[k].append(i)
    verts = [i for i in range(L) if int(ss[i]) > i]
    verts.sort(key=lambda x: -len(g[x]))

    c = np.full(L, -1, dtype=np.int64)
    max_color = 0
    for i in verts:
        used = sorted({int(c[k]) for k in g[i] if c[k] >= 0})
        col = 0
        while col < len(used) and used[col] == col:
            col += 1
        c[i] = col
        max_color = max(max_color, col)

    count = np.zeros(max_color + 1, dtype=np.int64)
    for i in range(L):
        if c[i] >= 0:
            count[c[i]] += 1
    idx = sorted(range(len(count)), key=lambda x: -int(count[x]))
    rev = np.zeros(len(idx), dtype=np.int64)
    for r, x in enumerate(idx):
        rev[x] = r
    plevel = np.full(L, -1, dtype=np.int64)
    for i in range(L):
        if c[i] >= 0:
            plevel[i] = rev[c[i]]
    return plevel


def decode(p: np.ndarray, th, w=None, q=None, levelwise: bool = True):
    """Returns (ss, bracket string). p: (L, L) averaged BP matrix.

    levelwise=True (reference default, src/ipknot.cpp:43): per-level planarity
    and must-cross-lower constraints keep each bracket level planar.
    levelwise=False: those constraints are dropped (src/ipknot.cpp:160) and
    bracket levels are recomputed by greedy graph coloring (decompose_plevel).
    """
    L = p.shape[0]
    P = len(th)
    th = list(th)
    vars_, wts = _variables(p, th, w, q)
    nv = len(vars_)
    if nv == 0:
        return np.full(L, -1, dtype=np.int64), "." * L, 0.0

    by_level: list[list[tuple[int, int, int]]] = [[] for _ in range(P)]
    for k, (lv, i, j) in enumerate(vars_):
        by_level[lv].append((k, i, j))

    rows, lb, ub = _build_rows(vars_, L, P, levelwise)

    data, ri, ci = [], [], []
    for r, coeffs in enumerate(rows):
        for k, c in coeffs:
            ri.append(r)
            ci.append(k)
            data.append(c)
    A = sparse.csr_matrix((data, (ri, ci)), shape=(len(rows), nv))

    res = milp(
        c=-np.array(wts),  # maximize
        constraints=LinearConstraint(A, np.array(lb), np.array(ub)),
        integrality=np.ones(nv),
        bounds=(0, 1),
    )
    if res.x is None:
        return np.full(L, -1, dtype=np.int64), "." * L, 0.0
    sol = res.x > 0.5
    score = float(np.dot(np.array(wts), sol.astype(np.float64)))

    ss = np.full(L, -1, dtype=np.int64)
    plevel = np.full(L, -1, dtype=np.int64)
    for lv in range(P):
        for (k, i, j) in by_level[lv]:
            if sol[k]:
                ss[i] = j
                plevel[i] = plevel[j] = lv
    if not levelwise:
        plevel = decompose_plevel(ss)
    s = ["."] * L
    for i in range(L):
        j = ss[i]
        if j >= 0 and i < j and plevel[i] < len(LEFT):
            s[i] = LEFT[plevel[i]]
            s[j] = RIGHT[plevel[i]]
    return ss, "".join(s), score
