"""SparseNeedlemanWunsch MEA alignment decoder (src/needleman_wunsch.cpp:198-422).

Port of `dafs_tpu/ops/nw.py`, batched over problems.  The envelope is host
numpy (copied as it is); the banded DP sweeps rows, and within a row the
gap-in-seq1 ('Y') dependency is a running maximum, exact in max-plus
algebra, while the tie-breaking ('M' wins against 'X' when equal, 'Y' only
when strictly greater than both) is reproduced cell for cell.

Traceback codes: 0 = none, 1 = 'M', 2 = 'X', 3 = 'Y'.  On a CUDA tensor
`decode` runs kernel K4 (`nw_cuda`, traceback in the kernel); on a CPU
tensor it runs `decode_plain`, whose traceback runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch


LOWEST = float(np.finfo(np.float32).min)


def envelope(p: np.ndarray, th: float) -> np.ndarray:
    """Alignment envelope, replicating initialize() (needleman_wunsch.cpp:198-253).

    Returns (L1+1, 2) int array of [first, last] per DP row.
    """
    L1, L2 = p.shape
    env = np.zeros((L1 + 1, 2), dtype=np.int64)
    pos = (p - np.float32(th)) >= 0.0
    for i in range(1, L1 + 1):
        row = pos[i - 1]
        nz = np.nonzero(row)[0]
        if nz.size:
            k = int(nz[0]) + 1  # first alignable point (1-based)
            env[i - 1, 0] = min(env[i - 1, 0], k - 1)
            env[i, 0] = k
        if env[i, 0] == 0:
            env[i, 0] = env[i - 1, 0]
            env[i, 1] = env[i - 1, 1]
            continue
        k = int(nz[-1]) + 1  # last alignable point
        env[i - 1, 1] = max(env[i - 1, 1], k - 1)
        env[i, 1] = k
    assert env[0, 0] == 0
    env[L1, 1] = L2
    # force monotonicity
    v = L2
    for i in range(L1, 0, -1):
        v = min(v, env[i, 0])
        env[i, 0] = v
    v = 0
    for i in range(L1 + 1):
        v = max(v, env[i, 1])
        env[i, 1] = v
    # connectivity
    for i in range(1, L1 + 1):
        if env[i - 1, 1] < env[i, 0]:
            env[i, 0] = env[i - 1, 1]
    return env


def traceback(tr: np.ndarray, l1: int, l2: int, L1: int) -> np.ndarray:
    """Host traceback of one problem from its (L1+1, L2+1) code table; al
    (L1,) int32 with al[i] = matched column of seq2 or -1."""
    al = np.full(L1, -1, np.int32)
    i, k = l1, l2
    while i > 0 or k > 0:
        code = tr[i, k]
        if code == 1:
            al[i - 1] = k - 1
            i -= 1
            k -= 1
        elif code == 2:
            al[i - 1] = -1
            i -= 1
        else:
            k -= 1
    return al


def decode_plain(sm, env_first, env_last, l1, l2):
    """Plain version of kernel K4: (score (B,) float32, al (B, L1) int32)."""
    B, L1, L2 = sm.shape
    dev = sm.device
    kk = torch.arange(L2 + 1, device=dev)[None, :]
    lowest = torch.full((B, 1), LOWEST, dtype=torch.float32, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    dp_prev = torch.zeros((B, L2 + 1), dtype=torch.float32, device=dev)
    tr = torch.zeros((B, L1 + 1, L2 + 1), dtype=torch.int32, device=dev)
    tr[:, 0, 1:] = 3
    score = torch.zeros((B,), dtype=torch.float32, device=dev)
    l2i = l2.long()[:, None]
    for i in range(1, L1 + 1):
        start = torch.clamp(env_first[:, i], min=1)[:, None]
        in_band = (kk >= start) & (kk <= env_last[:, i][:, None])
        m_cand = dp_prev[:, :-1] + sm[:, i - 1]  # dp[i-1][k-1] + score
        x_cand = dp_prev[:, 1:]                  # dp[i-1][k]
        ge = m_cand >= x_cand
        b = torch.cat([zero, torch.where(ge, m_cand, x_cand)], dim=1)
        b_code = torch.cat([
            torch.full((B, 1), 2, dtype=torch.int32, device=dev),
            torch.where(ge, 1, 2).to(torch.int32),
        ], dim=1)
        c = torch.where(in_band, b, LOWEST)
        c[:, 0] = torch.where(start[:, 0] == 1, 0.0, LOWEST)
        run = torch.cummax(c, dim=1).values
        left = torch.cat([lowest, run[:, :-1]], dim=1)
        dp_row = torch.where(in_band, torch.maximum(b, left), LOWEST)
        dp_row[:, 0] = 0.0
        tr_row = torch.where(left > b, 3, b_code)
        tr_row = torch.where(in_band, tr_row, 0)
        tr_row[:, 0] = 2
        tr[:, i] = tr_row
        score = torch.where(l1 == i, dp_row.gather(1, l2i)[:, 0], score)
        dp_prev = dp_row
    tr_np = tr.cpu().numpy()
    l1_np, l2_np = l1.cpu().numpy(), l2.cpu().numpy()
    al = np.stack([
        traceback(tr_np[b], int(l1_np[b]), int(l2_np[b]), L1) for b in range(B)
    ])
    return score, torch.from_numpy(al).to(dev)


def decode(sm, env_first, env_last, l1, l2):
    """Banded MEA alignment decode of a batch.

    sm: (B, L1, L2) float32 cell scores, built as ``p-th(+q)`` in reference
    float order (needleman_wunsch.cpp:281); env_first, env_last: (B, L1+1)
    int32 envelope bounds per DP row; l1, l2: (B,) int32 true lengths.
    Returns (score (B,) = dp[l1][l2], al (B, L1) int32).
    """
    return decode_plain(sm, env_first, env_last, l1, l2)
