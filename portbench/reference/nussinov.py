"""SparseNussinov MEA structure decoder (src/nussinov.cpp:207-298).

Port of `dafs_tpu/ops/nussinov.py`, batched over problems: `sm` (B, L, L)
holds one padded score matrix per problem and `lens` (B,) the true lengths.
Cells at or beyond the true length never influence the result, so problems
of different lengths share one padded batch.

Tie-breaking replicates the reference exactly: candidates are evaluated in
the order [down (i+1, j), left (i, j-1), pair (i, j), bifurcations] and the
first maximum wins; among bifurcations (i, k-1) + (k, j) the largest split
k wins (the C++ scans k downward and replaces only on strictly greater).

Layout (both versions): diagonal-major tables, `DL[span, i] = dp(i, i+span)`
and `ML[span, i] = m(i, i+span)`, the pair value of (i, j) or NEG.  A cell's
traceback code is 0 (none), 1 (down), 2 (left), 3 (pair) or 3 + (k - i)
for the bifurcation at split k.

On a CUDA tensor `decode` runs kernel K3 (`nussinov_cuda`, traceback in
the kernel); on a CPU tensor it runs `decode_plain`, whose traceback runs on
the host.
"""

from __future__ import annotations

import numpy as np
import torch


NEG = float(np.float32(-3e38))


def score_matrix(w, p, q, th):
    """sm[i][j] = w*(p[i][j]-th) - q[i][j] in reference float32 order
    (src/nussinov.cpp:236); `w`, `th` are float32 scalars or broadcastable
    tensors."""
    return w * (p - th) - q


def traceback(code: np.ndarray, l: int) -> np.ndarray:
    """Host traceback of one problem from its (L, L) code table; ss (L,)
    int32 with ss[i] = j for every decoded pair (i, j), -1 elsewhere."""
    L = code.shape[0]
    ss = np.full(L, -1, np.int32)
    stack = [(0, l - 1)]
    while stack:
        i, j = stack.pop()
        c = int(code[j - i, i]) if j > i else 0
        if c == 1:
            stack.append((i + 1, j))
        elif c == 2:
            stack.append((i, j - 1))
        elif c == 3:
            ss[i] = j
            stack.append((i + 1, j - 1))
        elif c >= 4:
            k = i + c - 3
            ss[k] = j
            stack.append((i, k - 1))
            stack.append((k + 1, j - 1))
    return ss


def decode_plain(sm: torch.Tensor, lens: torch.Tensor):
    """Plain version of kernel K3: (score (B,) float32, ss (B, L) int32)."""
    B, L, _ = sm.shape
    dev = sm.device
    DL = torch.zeros((B, L, L), dtype=torch.float32, device=dev)
    ML = torch.full((B, L, L), NEG, dtype=torch.float32, device=dev)
    CODE = torch.zeros((B, L, L), dtype=torch.int32, device=dev)
    ar = torch.arange(L, device=dev)
    for ld in range(1, L):
        n = L - ld
        i = ar[:n]
        s = sm[:, i, i + ld]
        if ld >= 2:
            t1 = DL[:, ld - 1, 1 : n + 1]   # dp(i+1, j)
            t2 = DL[:, ld - 1, :n]          # dp(i, j-1)
        else:
            t1 = t2 = torch.full_like(s, NEG)
        if ld >= 3:
            m = torch.where(s > 0.0, DL[:, ld - 2, 1 : n + 1] + s, NEG)
        else:
            m = torch.full_like(s, NEG)
        v, code = t1, torch.ones_like(s, dtype=torch.int32)
        code = torch.where(t2 > v, 2, code)
        v = torch.maximum(v, t2)
        code = torch.where(m > v, 3, code)
        v = torch.maximum(v, m)
        if ld >= 4:
            o = torch.arange(1, ld - 2, device=dev)  # split k = i + o
            cand = DL[:, o - 1, :n] + ML[:, ld - o[:, None], i[None, :] + o[:, None]]
            best = cand.max(dim=1).values
            # largest split among the maxima
            bo = torch.where(cand == best[:, None], o[None, :, None], 0).amax(dim=1)
            code = torch.where(best > v, (bo + 3).to(torch.int32), code)
            v = torch.maximum(v, best)
        has_any = v > NEG
        DL[:, ld, :n] = torch.where(has_any, v, 0.0)
        ML[:, ld, :n] = m
        CODE[:, ld, :n] = torch.where(has_any, code, 0)
    lens_np = lens.cpu().numpy()
    score = DL[torch.arange(B, device=dev), (lens.long() - 1).clamp(min=0), 0]
    code_np = CODE.cpu().numpy()
    ss = np.stack([traceback(code_np[b], int(lens_np[b])) for b in range(B)])
    return score, torch.from_numpy(ss).to(dev)


def decode(sm: torch.Tensor, lens: torch.Tensor):
    """MEA Nussinov decode of a batch: (score (B,), ss (B, L) int32)."""
    return decode_plain(sm, lens)
