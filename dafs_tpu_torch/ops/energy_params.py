"""RNA thermodynamic parameters for the McCaskill partition function.

Two parameter sets, mirroring the reference's `-s Boltzmann` / `-s Vienna`
(src/fold.cpp:70-76):

- "Vienna": ViennaRNA 2.4.x defaults (Turner 2004 rules).
- "Boltzmann" (default): the same, with the Andronescu et al. (RNA 2010)
  BL* overrides applied exactly as copy_boltzmann_parameters does
  (src/boltzmann_param.c:6010-6026) — note it overrides stacks, hairpin/
  bulge/internal lengths, H/I mismatches, dangles, int11/21/22, ML params,
  NINIO and the tetraloop table, but NOT the exterior/multiloop mismatches,
  1xN / 2x3 interior mismatches, tri/hexaloops or lxc, which stay at their
  Turner-2004 defaults.

Pair types (Vienna order): 0=none, 1=CG, 2=GC, 3=GU, 4=UG, 5=AU, 6=UA, 7=NN.
Bases: 0=N, 1=A, 2=C, 3=G, 4=U.  Energies in dcal/mol at 37C.

The Turner-2004 default tables below are reconstructed from the published
parameter set (Mathews et al. 2004 / NNDB; distributed with ViennaRNA as
rna_turner2004.par).  Exterior and multiloop mismatches in that set are the
sums of the corresponding 5' and 3' dangles.

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import os

import numpy as np

INF = 10000000
MAXLOOP = 30
TURN = 3
K0 = 273.15
GASCONST = 1.98717  # cal/(mol K)
TEMP37 = 37.0
LXC37 = 107.856

NBPAIRS = 7

# pair[a][b] for bases N A C G U
BP_PAIR = np.array(
    [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 5],
        [0, 0, 0, 1, 0],
        [0, 0, 2, 0, 3],
        [0, 6, 0, 4, 0],
    ],
    dtype=np.int32,
)
RTYPE = np.array([0, 2, 1, 4, 3, 6, 5, 7], dtype=np.int32)

# ---------------------------------------------------------------------------
# Turner 2004 defaults (ViennaRNA 2.4.x) — only the tables NOT overridden by
# BL* are actually consumed from here in the default configuration.
# ---------------------------------------------------------------------------

# dangle5 / dangle3, rows CG GC GU UG AU UA NN, cols N A C G U
_T04_DANGLE5 = np.array(
    [
        [0, 0, 0, 0, 0],          # no pair
        [-10, -50, -30, -20, -10],  # CG
        [0, -20, -30, 0, 0],        # GC
        [-20, -30, -30, -40, -20],  # GU
        [-10, -30, -10, -20, -20],  # UG
        [-20, -30, -30, -40, -20],  # AU
        [-10, -30, -10, -20, -20],  # UA
        [0, 0, 0, 0, 0],            # NN
    ],
    dtype=np.int32,
)
_T04_DANGLE3 = np.array(
    [
        [0, 0, 0, 0, 0],
        [-40, -110, -40, -130, -60],   # CG
        [-40, -170, -80, -170, -120],  # GC
        [-20, -70, -10, -70, -10],     # GU
        [-40, -80, -50, -80, -60],     # UG
        [-20, -70, -10, -70, -10],     # AU
        [-40, -80, -50, -80, -60],     # UA
        [0, 0, 0, 0, 0],
    ],
    dtype=np.int32,
)


def _dangle_sum_mismatch(d5: np.ndarray, d3: np.ndarray) -> np.ndarray:
    """mismatch_exterior / mismatch_multi = dangle5[si] + dangle3[sj]
    (Turner 2004 treats exterior/multiloop terminal stacking as the sum of
    independent dangle contributions)."""
    m = d5[:, :, None] + d3[:, None, :]
    # N rows/cols: ViennaRNA uses the plain dangle values there as well
    return m.astype(np.int32)


MISMATCH_EXT_T04 = _dangle_sum_mismatch(_T04_DANGLE5, _T04_DANGLE3)
MISMATCH_M_T04 = _dangle_sum_mismatch(_T04_DANGLE5, _T04_DANGLE3)

# 1xN interior loops: no sequence-dependent mismatch, AU/GU closure penalty 70
_m1n = np.zeros((NBPAIRS + 1, 5, 5), dtype=np.int32)
for _t in (3, 4, 5, 6, 7):
    _m1n[_t] = 70
MISMATCH_1NI_T04 = _m1n

# 2x3 interior loops: closure penalty 70 for AU/GU plus the Turner-2004
# first-mismatch bonuses (NNDB / rna_turner2004.par mismatch_interior_23):
# A·G -50, G·A -110, G·G -70, U·U -30 (dcal), applied on both loop ends.
_m23 = np.zeros((NBPAIRS + 1, 5, 5), dtype=np.int32)
for _t in (3, 4, 5, 6, 7):
    _m23[_t] = 70
for _t in range(1, NBPAIRS + 1):
    _m23[_t, 1, 3] += -50   # A·G
    _m23[_t, 3, 1] += -110  # G·A
    _m23[_t, 3, 3] += -70   # G·G
    _m23[_t, 4, 4] += -30   # U·U
MISMATCH_23I_T04 = _m23

TRILOOPS_T04 = {"CAACG": 680, "GUUAC": 690}
HEXALOOPS_T04 = {
    "ACAGUACU": 280,
    "ACAGUGAU": 360,
    "ACAGUGCU": 290,
    "ACAGUGUU": 180,
}

def pf_smooth(e):
    """Vienna params.c SMOOTH applied in the energy domain: the effective
    pf energy for dangles / exterior / multiloop mismatches (pf_smooth=1).
    Returns -SMOOTH(-e) so exp(-pf_smooth(e)*10/kT) == the pf factor."""
    x = -np.asarray(e, dtype=np.float64)
    xs = x / 10.0
    g = np.where(
        xs < -1.2283697,
        0.0,
        np.where(
            xs > 0.8660254,
            x,
            10.0 * 0.38490018 * (np.sin(xs - 0.34242663) + 1.0) ** 2,
        ),
    )
    return -g


_BL = None


def bl_tables() -> dict:
    global _BL
    if _BL is None:
        _BL = dict(np.load(BL_STAR_PATH, allow_pickle=False))
    return _BL


# The BL* tables are data of the JAX package; the port reads the same file
# by path instead of carrying a second copy.
BL_STAR_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "dafs_tpu", "ops",
    "data", "bl_star_params.npz",
)

# Turner 2004 base tables for the "Vienna" (non-BL) model.  For round 1 the
# BL* set (the DAFS default) is the priority; the "Vienna" variant reuses the
# BL* tables where Turner-2004 values have not been transcribed yet and is
# marked experimental in the CLI docs.

# Overrides applied on top of the assembled parameter set (energies in dcal):
# `-P FILE` installs the tables of a ViennaRNA parameter file here
# (`ops/param_file.py`).  A process-wide setting, as in the JAX package.
PARAM_OVERRIDES: dict = {}


def set_param_overrides(over: dict) -> None:
    """Replace PARAM_OVERRIDES and clear every table memo built from the
    parameters (McCaskill's and the consensus's)."""
    global PARAM_OVERRIDES
    PARAM_OVERRIDES = dict(over)
    from dafs_tpu_torch.ops import alifold, mccaskill

    mccaskill._FAST_TABLES.clear()
    alifold._TABLES.clear()


def params(bl: bool = True) -> dict:
    """Assemble the integer parameter set (dcal/mol)."""
    t = bl_tables()
    p = {
        "stack": t["stack37"],
        "hairpin": t["hairpin37"],
        "bulge": t["bulge37"],
        "internal": t["internal_loop37"],
        "mismatchH": t["mismatchH37"],
        "mismatchI": t["mismatchI37"],
        "mismatch1nI": MISMATCH_1NI_T04,
        "mismatch23I": MISMATCH_23I_T04,
        "mismatchExt": MISMATCH_EXT_T04,
        "mismatchM": MISMATCH_M_T04,
        "dangle5": t["dangle5_37"],
        "dangle3": t["dangle3_37"],
        "int11": t["int11_37"],
        "int21": t["int21_37"],
        "int22": t["int22_37"],
        "ml_base": int(t["ML_BASE37"]),
        "ml_closing": int(t["ML_closing37"]),
        "ml_intern": int(t["ML_intern37"]),
        "terminal_au": int(t["TerminalAU37"]),
        "ninio": int(t["ninio37"]),
        "max_ninio": int(t["MAX_NINIO"]),
        "lxc": LXC37,
        "tetraloops": {
            s: int(e) for s, e in zip(t["tetraloop_seqs"], t["tetraloop37"])
        },
        "triloops": TRILOOPS_T04,
        "hexaloops": HEXALOOPS_T04,
    }
    p.update(PARAM_OVERRIDES)
    return p


def encode_rna(seq: str) -> np.ndarray:
    """Vienna base encoding: N=0 A=1 C=2 G=3 U/T=4."""
    table = np.zeros(256, dtype=np.int32)
    for i, chars in enumerate(["A", "C", "G", "U"]):
        table[ord(chars)] = i + 1
        table[ord(chars.lower())] = i + 1
    table[ord("T")] = 4
    table[ord("t")] = 4
    return table[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]


def exp_tables(bl: bool = True, temperature: float = TEMP37,
               kt_mult: int = 1) -> dict:
    """Boltzmann-factor tables: exp(-E * 10 / kT), kT in cal/mol.

    Dangles and exterior/multiloop mismatches use ViennaRNA's pf smoothing
    (params.c RESCALE_BF_SMOOTH with pf_smooth=1, the library default the
    reference runs under): factor = exp(SMOOTH(-E) * 10 / kT) where SMOOTH
    truncates destabilizing contributions to zero with a sin^2 ramp around
    the origin (SCALE=10).  All other tables use the plain Boltzmann factor
    (params.c RESCALE_BF).

    kt_mult: Vienna's comparative (alifold) pf params are generated with
    kTn = kT * n_seq (get_scaled_alipf_parameters / exp_params_comparative),
    so multiplying the per-sequence factors yields the AVERAGE sequence
    energy, not the sum.  Pass kt_mult=n_seq for consensus folding."""
    p = params(bl)
    kt = (temperature + K0) * GASCONST * kt_mult

    def b(e):
        e = np.asarray(e, dtype=np.float64)
        out = np.exp(-e * 10.0 / kt)
        out[np.asarray(e) >= INF] = 0.0
        return out

    def b_smooth(e):
        # Vienna params.c: SMOOTH(X) = 0 if X/SCALE < -1.2283697;
        # X if X/SCALE > 0.8660254; else
        # SCALE*0.38490018*(sin(X/SCALE-0.34242663)+1)^2, SCALE=10,
        # applied to X = -E so the factor is exp(SMOOTH(-E)*10/kT).
        out = np.exp(-pf_smooth(e) * 10.0 / kt)
        out[np.asarray(e) >= INF] = 0.0
        return out

    exp = {
        "kt": kt,
        "lxc": p["lxc"],
        "stack": b(p["stack"]),
        "hairpin": b(p["hairpin"]),
        "bulge": b(p["bulge"]),
        "internal": b(p["internal"]),
        "mismatchH": b(p["mismatchH"]),
        "mismatchI": b(p["mismatchI"]),
        "mismatch1nI": b(p["mismatch1nI"]),
        "mismatch23I": b(p["mismatch23I"]),
        "mismatchExt": b_smooth(p["mismatchExt"]),
        "mismatchM": b_smooth(p["mismatchM"]),
        "dangle5": b_smooth(p["dangle5"]),
        "dangle3": b_smooth(p["dangle3"]),
        "int11": b(p["int11"]),
        "int21": b(p["int21"]),
        "int22": b(p["int22"]),
        "ml_base": float(np.exp(-p["ml_base"] * 10.0 / kt)),
        "ml_closing": float(np.exp(-p["ml_closing"] * 10.0 / kt)),
        "ml_intern": float(np.exp(-p["ml_intern"] * 10.0 / kt)),
        "terminal_au": float(np.exp(-p["terminal_au"] * 10.0 / kt)),
        # ninio factors per asymmetry, pre-capped at MAX_NINIO
        "ninio": np.exp(
            -np.minimum(
                p["max_ninio"], np.arange(MAXLOOP + 1) * p["ninio"]
            ).astype(np.float64)
            * 10.0
            / kt
        ),
    }

    # special hairpin lookup tables over encoded k-mers (bases 1..4 -> 0..3)
    def kmer_table(d: dict, k: int) -> np.ndarray:
        tbl = np.full(4 ** k, -1.0, dtype=np.float64)
        code = {"A": 0, "C": 1, "G": 2, "U": 3}
        for s, e in d.items():
            v = 0
            for ch in s:
                v = v * 4 + code[ch]
            tbl[v] = np.exp(-e * 10.0 / kt)
        return tbl

    exp["tetraloop"] = kmer_table(p["tetraloops"], 6)
    exp["triloop"] = kmer_table(p["triloops"], 5)
    exp["hexaloop"] = kmer_table(p["hexaloops"], 8)
    return exp
