"""The alignment containers of the reference's data model (src/typedefs.h:27-44).

The reference keeps alignments (``ALN``) as per-sequence gap masks over
alignment columns, and its posterior matrices (``MP``/``BP``) as sparse
rows.  The port holds the posteriors as dense padded float32 arrays whose
entries at or below a threshold are exactly 0.0, which every consumer
reads as the reference reads an absent entry; it keeps the reference's
gap masks as `AlnRow`s.

`AlnRow` and `gapped_seq` are copied from the JAX package's module of the
same name: importing any
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
