"""CONTRAlign pair-CRF parameters (contralign/Defaults.ipp:389-419, RNA=1).

24 published weights of the CONTRAlign 2.0 RNA model (Do et al. 2006):
10 symmetric match emissions (AA..UU), 4 insert emissions, 3 state biases
(match/insert/insert2), 7 transition weights.  Alphabet "ACGU"; all other
characters (including T!) map to the unknown index 4 with zero scores
(contralign/InferenceEngine.ipp:59-63).

States: 0=MATCH, 1=INS_X, 2=INS_Y, 3=INS2_X, 4=INS2_Y (double-affine gaps).

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

K = 5
M_, IX, IY, I2X, I2Y = range(5)

_V = {
    "match_AA": 0.5256508867, "match_AC": -0.4090640200, "match_AG": -0.2502759109,
    "match_AU": -0.3252306723, "match_CC": 0.6665219366, "match_CG": -0.3289391181,
    "match_CU": -0.1326088918, "match_GG": 0.6684676551, "match_GU": -0.3565888168,
    "match_UU": 0.4590520450,
    "insert_A": -0.0025219272, "insert_C": -0.0831389156, "insert_G": -0.0744397065,
    "insert_U": -0.0129005460,
    "match": 0.3959924457, "insert": -0.4431756229, "insert2": -0.3488104904,
    "match_to_match": 2.5057567100, "match_to_insert": -1.2423961130,
    "insert_extend": 1.8676346730, "insert_change": -6.9696754440,
    "match_to_insert2": 0.1970448791, "insert2_extend": 1.0140265830,
    "insert2_change": -7.3469687820,
}


def encode(seq: str) -> np.ndarray:
    """A,C,G,U (case-insensitive) -> 0..3; everything else -> 4."""
    table = np.full(256, 4, dtype=np.int32)
    for i, ch in enumerate("ACGU"):
        table[ord(ch)] = i
        table[ord(ch.lower())] = i
    return table[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]


def tables() -> dict[str, np.ndarray]:
    f = np.float32
    match = np.zeros((5, 5), dtype=np.float32)
    order = "ACGU"
    for a in range(4):
        for b in range(4):
            key = "match_" + "".join(sorted(order[a] + order[b]))
            match[a, b] = f(_V[key])
    ins = np.zeros(5, dtype=np.float32)
    for a in range(4):
        ins[a] = f(_V["insert_" + order[a]])

    single = np.array(
        [_V["match"], _V["insert"], _V["insert"], _V["insert2"], _V["insert2"]],
        dtype=np.float32,
    )

    pair = np.zeros((K, K), dtype=np.float32)
    pair[M_, M_] = f(_V["match_to_match"])
    pair[M_, IX] = pair[M_, IY] = pair[IX, M_] = pair[IY, M_] = f(_V["match_to_insert"])
    pair[IX, IX] = pair[IY, IY] = f(_V["insert_extend"])
    pair[IX, IY] = pair[IY, IX] = f(_V["insert_change"])
    pair[M_, I2X] = pair[M_, I2Y] = pair[I2X, M_] = pair[I2Y, M_] = f(_V["match_to_insert2"])
    pair[I2X, I2X] = pair[I2Y, I2Y] = f(_V["insert2_extend"])
    pair[I2X, I2Y] = pair[I2Y, I2X] = f(_V["insert2_change"])

    return {"match": match, "ins": ins, "single": single, "pair": pair}
