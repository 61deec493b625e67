"""ProbCons-RNA pair-HMM parameters (probconsRNA/Defaults.h:19-40).

Published RNA-trained parameters of the ProbCons model (Do et al. 2005,
retrained on RNA by Hamada): 3 states (1 match + 1 insert pair),
alphabet "ACGUTN" with U==T.  We encode characters to a 7-letter code
(A,C,G,U,T,N,other); unknown chars fall back to the reference's default
emissions (pairs 1e-10, single 1e-5).

All derived tables are built with float32 arithmetic in the same expression
order as the reference (ProbabilisticModel.h:55-88) so the log-domain
constants match the C++ binary bit-for-bit.

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

NUM_STATES = 3  # M, Ix, Iy   (NumInsertStates=1, probconsRNA/CMakeLists.txt:5)

INIT_DISTRIB = np.array([0.9588437676, 0.0205782652, 0.0205782652], dtype=np.float32)
GAP_OPEN = np.array([0.0190259293, 0.0190259293], dtype=np.float32)
GAP_EXTEND = np.array([0.3269913495, 0.3269913495], dtype=np.float32)

ALPHABET = "ACGUTN"
N_CODES = 7  # A C G U T N other

EMIT_SINGLE = np.array(
    [0.2270790040, 0.2422080040, 0.2839320004, 0.2464679927, 0.2464679927, 0.0003124650, 1e-5],
    dtype=np.float32,
)

_EMIT_PAIRS_6 = np.array(
    [
        [0.1487240046, 0.0184142999, 0.0361397006, 0.0238473993, 0.0238473993, 0.0000375308],
        [0.0184142999, 0.1583919972, 0.0275536999, 0.0389291011, 0.0389291011, 0.0000815823],
        [0.0361397006, 0.0275536999, 0.1979320049, 0.0244289003, 0.0244289003, 0.0000824765],
        [0.0238473993, 0.0389291011, 0.0244289003, 0.1557479948, 0.1557479948, 0.0000743985],
        [0.0238473993, 0.0389291011, 0.0244289003, 0.1557479948, 0.1557479948, 0.0000743985],
        [0.0000375308, 0.0000815823, 0.0000824765, 0.0000743985, 0.0000743985, 0.0000263252],
    ],
    dtype=np.float32,
)

EMIT_PAIRS = np.full((N_CODES, N_CODES), 1e-10, dtype=np.float32)
EMIT_PAIRS[:6, :6] = _EMIT_PAIRS_6


def encode(seq: str) -> np.ndarray:
    """Map sequence characters to codes 0..6 (case-insensitive)."""
    table = np.full(256, 6, dtype=np.int8)
    for i, ch in enumerate(ALPHABET):
        table[ord(ch)] = i
        table[ord(ch.lower())] = i
    return table[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)].astype(np.int32)


def log_tables() -> dict[str, np.ndarray]:
    """Build log-domain parameter tables exactly as ProbabilisticModel.h:55-88."""
    f32 = np.float32
    trans = np.zeros((NUM_STATES, NUM_STATES), dtype=np.float32)
    trans[0, 0] = f32(1.0)
    trans[0, 1] = GAP_OPEN[0]
    trans[0, 2] = GAP_OPEN[1]
    trans[0, 0] = f32(trans[0, 0] - (GAP_OPEN[0] + GAP_OPEN[1]))
    trans[1, 1] = GAP_EXTEND[0]
    trans[2, 2] = GAP_EXTEND[1]
    trans[1, 2] = f32(0.0)
    trans[2, 1] = f32(0.0)
    trans[1, 0] = f32(1.0) - GAP_EXTEND[0]
    trans[2, 0] = f32(1.0) - GAP_EXTEND[1]

    def flog(x):
        # C++ `float LOG(float x) { return log(x); }`: double log, float result
        with np.errstate(divide="ignore"):
            return np.log(x.astype(np.float64)).astype(np.float32)

    return {
        "init": flog(INIT_DISTRIB),
        "trans": flog(trans),
        "match": flog(EMIT_PAIRS),
        "ins": flog(EMIT_SINGLE),
    }
