"""Guide tree construction and printing (src/dafs.cpp:446-511).

The reference's UPGMA-like agglomeration uses a max priority queue over
(similarity, (i, j)) with C++ pair comparison (lexicographic, ties broken by
larger indices) and the nonstandard merged-distance update
``d = (d_il + d_ir) * sim / 2`` (src/dafs.cpp:483).  Both are replicated
exactly — the whole downstream output depends on this tree.

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import heapq

import numpy as np

F = np.float32


def build_tree(sim: np.ndarray) -> list[tuple[float, tuple[int, int]]]:
    """Returns tree as list of (score, (left, right)); leaves are
    (0.0, (-1, -1)); nodes n..2n-2 are merges; root is the last entry."""
    n = sim.shape[0]
    tree: list[tuple[float, tuple[int, int]]] = [
        (0.0, (-1, -1)) for _ in range(2 * n - 1)
    ]
    d = np.zeros((2 * n - 1, 2 * n - 1), dtype=np.float32)
    idx = [-1] * (2 * n - 1)
    for i in range(n):
        idx[i] = i

    # heapq is a min-heap; C++ pops the lexicographically largest
    # (score, (i, j)) — so push (-score, -i, -j).
    pq: list[tuple[float, int, int]] = []
    for i in range(n - 1):
        for j in range(i + 1, n):
            d[i, j] = d[j, i] = sim[i, j]
            heapq.heappush(pq, (-float(F(sim[i, j])), -i, -j))

    m = n
    while pq:
        negs, ni, nj = heapq.heappop(pq)
        s, i, j = F(-negs), -ni, -nj
        if idx[i] != -1 and idx[j] != -1:
            # idx[] maps tree slots to distance-matrix representative rows;
            # the tree node stores the SLOT pair (src/dafs.cpp:475-488)
            left = idx[i]
            right = idx[j]
            idx[i] = idx[j] = -1
            for k in range(m):  # all existing slots (C++ `i != n` with live n)
                if idx[k] != -1:
                    kk = idx[k]
                    nd = F((d[kk, left] + d[kk, right]) * s / 2)
                    d[kk, left] = d[left, kk] = nd
                    heapq.heappush(pq, (-float(nd), -k, -m))
            tree[m] = (float(s), (i, j))
            idx[m] = left
            m += 1
    assert m == 2 * n - 1
    return tree


def _fmt(x: float) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    return f"{x:.6g}"


def print_tree(tree, names: list[str], i: int | None = None) -> str:
    if i is None:
        i = len(tree) - 1
    score, (l, r) = tree[i]
    if l == -1:
        return names[i]
    return f"[ {_fmt(score)} {print_tree(tree, names, l)} {print_tree(tree, names, r)} ]"
