"""Core containers mirroring the reference's data model (src/typedefs.h:27-44).

The reference keeps sparse row-major posterior matrices (``MP``/``BP``:
``vector<vector<pair<uint,float>>>``) and alignments (``ALN``) as per-sequence
gap masks over alignment columns.  On TPU the natural representation is dense
padded float32 matrices where "absent" entries are exactly 0.0; since every
consumer of MP/BP only *adds* weighted entries, a dense matrix whose
sub-threshold entries are zeroed is semantically identical to the reference's
sparse rows.  This module provides the dense containers plus the
sparsification helpers that reproduce the reference's threshold behavior.

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CUTOFF = 0.01  # src/dafs.cpp:65


@dataclasses.dataclass
class AlnRow:
    """One row of an alignment: sequence id + gap mask over columns."""

    seq_id: int
    mask: np.ndarray  # bool, shape (L,), True = residue, False = gap


ALN = list  # list[AlnRow]


def single_row_aln(seq_id: int, length: int) -> list[AlnRow]:
    return [AlnRow(seq_id, np.ones(length, dtype=bool))]


def threshold_dense(p: np.ndarray, th: float) -> np.ndarray:
    """Zero entries with p <= th (reference keeps strictly-greater entries)."""
    out = np.array(p, dtype=np.float32, copy=True)
    out[out <= th] = 0.0
    return out


def aln_length(aln: list[AlnRow]) -> int:
    return int(aln[0].mask.shape[0])


def gapped_seq(fa_seq: str, mask: np.ndarray) -> str:
    """Build the gapped string for one alignment row (src/dafs.cpp:1592-1599)."""
    out = []
    k = 0
    for m in mask:
        if m:
            out.append(fa_seq[k])
            k += 1
        else:
            out.append("-")
    return "".join(out)


def sparse_rows(p: np.ndarray, th: float = 0.0) -> list[list[tuple[int, float]]]:
    """Dense -> reference-style sparse rows, keeping entries strictly > th."""
    rows: list[list[tuple[int, float]]] = []
    for i in range(p.shape[0]):
        (js,) = np.nonzero(p[i] > th)
        rows.append([(int(j), float(p[i, j])) for j in js])
    return rows


def dense_from_sparse_rows(
    rows: list[list[tuple[int, float]]], shape: tuple[int, int]
) -> np.ndarray:
    p = np.zeros(shape, dtype=np.float32)
    for i, row in enumerate(rows):
        for j, v in row:
            p[i, j] = v
    return p
