"""The work of the Nussinov (K3) and NW (K4) decodes and the least time an
NVIDIA H100 could take for it.

The arithmetic is `chip_smoke.py`'s (`bound`, `nussinov_bound`,
`nw_bound`), copied: work is counted within the true lengths, each input
byte read once and each output byte written once.  Peaks: NVIDIA's H100
SXM data sheet, dense, at its 700 W power limit: 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s of HBM.  Both decodes are float32
adds and compares, so the tensor-core rates do not apply.
"""

from __future__ import annotations

import numpy as np

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the operations over the float32 rate and the bytes
    over the memory rate."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def nussinov_work(lens: np.ndarray, L: int) -> tuple[float, float]:
    """(operations, bytes) of one batched decode of problems of true
    lengths `lens` padded to L: one add and one compare per bifurcation
    term, the sum over ld of (l - ld)(ld - 3); bytes: the upper triangle of
    the scores within l, the lengths, the score and ss."""
    ops = nbytes = 0.0
    for l in np.asarray(lens).astype(np.int64):
        ld = np.arange(4, max(l, 4))
        ops += 2.0 * float(((l - ld) * (ld - 3)).sum())
        nbytes += 4.0 * l * (l + 1) / 2
    return ops, nbytes + 4 * len(lens) * (2 + L)


def nw_work(env_first: np.ndarray, env_last: np.ndarray, l1: np.ndarray,
            L1: int) -> tuple[float, float]:
    """(operations, bytes) of one batched banded decode: five operations
    per cell inside the envelope (add, M/X compare, the two maxima of the
    row scan and dp, the Y compare); bytes: those cells' scores, the
    envelope rows within l1, the score and al."""
    l1 = np.asarray(l1).astype(np.int64)
    cells = 0.0
    for b in range(len(l1)):
        rows = np.arange(1, int(l1[b]) + 1)
        width = env_last[b, rows] - np.maximum(env_first[b, rows], 1) + 1
        cells += float(np.maximum(width, 0).sum()) + len(rows)
    nbytes = 4 * cells + 8 * float((l1 + 1).sum()) + 4 * len(l1) * (1 + L1)
    return 5 * cells, nbytes
