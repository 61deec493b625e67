"""CONTRAfold v2 parameter tables (from the 708 published weights).

Builds dense numpy tables indexed the way the recursions consume them
(contrafold/InferenceEngine.ipp RegisterParameters, :419-940):
base symbols A,C,G,U -> 0..3, unknown -> 4 (all-zero table rows).

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import os
import re

import numpy as np

M = 4  # alphabet size
A_ = "ACGU"

_CACHE = None

# The weights are data of the JAX package; the port reads the same file by
# path instead of carrying a second copy.
PARAMS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "dafs_tpu", "ops",
    "data", "contrafold_params.npz",
)


def _raw() -> dict[str, float]:
    d = np.load(PARAMS_PATH, allow_pickle=False)
    return {str(n): float(v) for n, v in zip(d["names"], d["values"])}


def _ladder(raw: dict, prefix: str, n: int) -> np.ndarray:
    """cache[i] = sum of at_least[k] for k <= i (InitializeCache cumsums)."""
    at_least = np.zeros(n + 1, dtype=np.float64)
    for k, v in raw.items():
        m = re.match(rf"{prefix}_at_least_(\d+)$", k)
        if m:
            at_least[int(m.group(1))] = v
    return np.cumsum(at_least)


def tables() -> dict[str, np.ndarray]:
    global _CACHE
    if _CACHE is None:
        raw = _raw()

        def g(name):
            return raw.get(name, 0.0)

        bp = np.zeros((5, 5))
        for i in range(M):
            for j in range(M):
                nm = "base_pair_" + "".join(sorted(A_[i] + A_[j]))
                bp[i, j] = g(nm)

        tm = np.zeros((5, 5, 5, 5))
        for i1 in range(M):
            for j1 in range(M):
                for i2 in range(M):
                    for j2 in range(M):
                        tm[i1, j1, i2, j2] = g(
                            f"terminal_mismatch_{A_[i1]}{A_[j1]}{A_[i2]}{A_[j2]}"
                        )

        hs = np.zeros((5, 5, 5, 5))
        for i1 in range(M):
            for j1 in range(M):
                for i2 in range(M):
                    for j2 in range(M):
                        n1 = f"helix_stacking_{A_[i1]}{A_[j1]}{A_[i2]}{A_[j2]}"
                        n2 = f"helix_stacking_{A_[j2]}{A_[i2]}{A_[j1]}{A_[i1]}"
                        hs[i1, j1, i2, j2] = g(min(n1, n2))

        hc = np.zeros((5, 5))
        for i in range(M):
            for j in range(M):
                hc[i, j] = g(f"helix_closing_{A_[i]}{A_[j]}")

        dl = np.zeros((5, 5, 5))
        dr = np.zeros((5, 5, 5))
        for i1 in range(M):
            for j1 in range(M):
                for k in range(M):
                    dl[i1, j1, k] = g(f"dangle_left_{A_[i1]}{A_[j1]}{A_[k]}")
                    dr[i1, j1, k] = g(f"dangle_right_{A_[i1]}{A_[j1]}{A_[k]}")

        b0x1 = np.zeros(5)
        for i in range(M):
            b0x1[i] = g(f"bulge_0x1_nucleotides_{A_[i]}")
        i1x1 = np.zeros((5, 5))
        for i in range(M):
            for j in range(M):
                n1 = f"internal_1x1_nucleotides_{A_[i]}{A_[j]}"
                n2 = f"internal_1x1_nucleotides_{A_[j]}{A_[i]}"
                i1x1[i, j] = g(n1 if n1 in raw else n2)

        explicit = np.zeros((5, 5))
        for i in range(1, 5):
            for j in range(1, 5):
                explicit[i, j] = g(f"internal_explicit_{min(i,j)}_{max(i,j)}")

        hairpin_len = _ladder(raw, "hairpin_length", 30)
        bulge_len = _ladder(raw, "bulge_length", 30)
        internal_len = _ladder(raw, "internal_length", 30)
        internal_sym = _ladder(raw, "internal_symmetric_length", 15)
        internal_asym = _ladder(raw, "internal_asymmetry", 28)

        # cache_score_single[l1][l2] (InitializeCache, InferenceEngine.ipp:1160-1200)
        single = np.zeros((31, 31))
        for l1 in range(31):
            for l2 in range(31 - l1):
                if l1 == 0 and l2 == 0:
                    continue
                if l1 == 0 or l2 == 0:
                    single[l1, l2] = bulge_len[min(30, l1 + l2)]
                else:
                    v = internal_len[min(30, l1 + l2)]
                    if l1 <= 4 and l2 <= 4:
                        v += explicit[l1, l2]
                    if l1 == l2:
                        v += internal_sym[min(15, l1)]
                    v += internal_asym[min(28, abs(l1 - l2))]
                    single[l1, l2] = v

        _CACHE_local = {
            "base_pair": bp,
            "terminal_mismatch": tm,
            "helix_stacking": hs,
            "helix_closing": hc,
            "dangle_left": dl,
            "dangle_right": dr,
            "bulge_0x1": b0x1,
            "internal_1x1": i1x1,
            "hairpin_len": hairpin_len,
            "single": single,
            "multi_base": g("multi_base"),
            "multi_paired": g("multi_paired"),
            "multi_unpaired": g("multi_unpaired"),
            "external_paired": g("external_paired"),
            "external_unpaired": g("external_unpaired"),
        }
        globals()["_CACHE"] = {
            k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) else np.float32(v))
            for k, v in _CACHE_local.items()
        }
    return _CACHE


def encode(seq: str) -> np.ndarray:
    """A,C,G,U -> 0..3 (case-insensitive), everything else -> 4."""
    table = np.full(256, 4, dtype=np.int32)
    for i, ch in enumerate(A_):
        table[ord(ch)] = i
        table[ord(ch.lower())] = i
    return table[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]


# complementarity mask (AU, GU, CG and inverses; InferenceEngine.ipp:391-396)
COMPLEMENTARY = np.zeros((5, 5), dtype=bool)
for _a, _b in [(0, 3), (3, 0), (2, 3), (3, 2), (1, 2), (2, 1)]:
    COMPLEMENTARY[_a, _b] = True
