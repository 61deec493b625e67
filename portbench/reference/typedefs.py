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
