"""Posterior averaging over groups and alignment projections.

Host-side mirrors of DAFS::average_matching_probability (src/dafs.cpp:513-559),
average_basepairing_probability (:561-607), project_alignment (:766-825) and
project_secondary_structure (:827-873).  These run per merge step on small
matrices; numpy fancy indexing replaces the reference's sparse walks.  Each
average is a span "projection.average" (`utils/spans.py`).

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

from dafs_tpu_torch.typedefs import CUTOFF, AlnRow
from dafs_tpu_torch.utils import spans

F = np.float32


def average_matching_probability(
    mp: np.ndarray, aln1: list[AlnRow], aln2: list[AlnRow]
) -> np.ndarray:
    """Group-to-group mean match matrix over alignment columns."""
    L1 = int(aln1[0].mask.shape[0])
    L2 = int(aln2[0].mask.shape[0])
    N1, N2 = len(aln1), len(aln2)
    with spans.span("projection.average", kind="mp", n1=N1, n2=N2, L1=L1, L2=L2):
        p = np.zeros((L1, L2), dtype=np.float32)
        for r1 in aln1:
            idx1 = np.nonzero(r1.mask)[0]
            for r2 in aln2:
                idx2 = np.nonzero(r2.mask)[0]
                m = mp[r1.seq_id, r2.seq_id][: len(idx1), : len(idx2)]
                p[np.ix_(idx1, idx2)] += np.float32(m / F(N1 * N2))
        p[p <= CUTOFF] = 0.0
        np.minimum(p, 1.0, out=p)
    return p


def average_basepairing_probability(
    bp: np.ndarray,
    aln: list[AlnRow],
    alifold_bp: np.ndarray | None = None,
) -> np.ndarray:
    """Alignment-projected mean BP matrix, optionally mixed 50/50 with the
    RNAalifold consensus BP matrix (passed in by the caller)."""
    L = int(aln[0].mask.shape[0])
    N = len(aln)
    with spans.span("projection.average", kind="bp", n=N, L=L):
        p = np.zeros((L, L), dtype=np.float32)
        for r in aln:
            idx = np.nonzero(r.mask)[0]
            b = bp[r.seq_id][: len(idx), : len(idx)]
            p[np.ix_(idx, idx)] += np.float32(b / F(N))
        if alifold_bp is not None:
            p += alifold_bp
            iu = np.triu_indices(L, 1)
            p[iu] = np.float32(p[iu] / F(2.0))
        p[np.tril_indices(L, 0)] = 0.0
        p[p <= CUTOFF] = 0.0
    return p


def project_alignment(
    aln1: list[AlnRow], aln2: list[AlnRow], z: np.ndarray
) -> list[AlnRow]:
    """Merge two alignments given column matching z (z[i]=k or -1)."""
    L1 = int(aln1[0].mask.shape[0])
    L2 = int(aln2[0].mask.shape[0])
    c = int((z >= 0).sum())
    L = L1 + L2 - c
    out: list[AlnRow] = []
    for q in aln1:
        mask = np.zeros(L, dtype=bool)
        r = 0
        k = 0
        for i in range(L1):
            if z[i] >= 0:
                while k < z[i]:
                    mask[r] = False
                    r += 1
                    k += 1
                mask[r] = q.mask[i]
                r += 1
                k += 1
            else:
                mask[r] = q.mask[i]
                r += 1
        while k < L2:
            mask[r] = False
            r += 1
            k += 1
        out.append(AlnRow(q.seq_id, mask))
    for q in aln2:
        mask = np.zeros(L, dtype=bool)
        k = 0
        r = 0
        for i in range(L1):
            if z[i] >= 0:
                while k < z[i]:
                    mask[r] = q.mask[k]
                    r += 1
                    k += 1
                mask[r] = q.mask[k]
                r += 1
                k += 1
            else:
                mask[r] = False
                r += 1
        while k < L2:
            mask[r] = q.mask[k]
            r += 1
            k += 1
        out.append(AlnRow(q.seq_id, mask))
    return out


def project_secondary_structure(
    x: np.ndarray, y: np.ndarray, z: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Remap per-group structures into merged coordinates (src/dafs.cpp:827-873)."""
    L1, L2 = len(x), len(y)
    idx1 = np.full(L1, -1, dtype=np.int64)
    idx2 = np.full(L2, -1, dtype=np.int64)
    r = 0
    k = 0
    for i in range(L1):
        if z[i] >= 0:
            while k < z[i]:
                idx2[k] = r
                r += 1
                k += 1
            idx1[i] = r
            idx2[k] = r
            r += 1
            k += 1
        else:
            idx1[i] = r
            r += 1
    while k < L2:
        idx2[k] = r
        r += 1
        k += 1
    L = r
    xx = np.full(L, -1, dtype=np.int64)
    yy = np.full(L, -1, dtype=np.int64)
    for i in range(L1):
        if x[i] >= 0:
            xx[idx1[i]] = idx1[x[i]]
    for k in range(L2):
        if y[k] >= 0:
            yy[idx2[k]] = idx2[y[k]]
    return xx, yy
