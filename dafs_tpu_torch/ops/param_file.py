"""ViennaRNA 2.x parameter-file (.par) loader.

The reference's `-s Vienna` configuration is ViennaRNA's compiled-in Turner
2004 set (src/fold.cpp:78-116 without copy_boltzmann_parameters).  That file
(rna_turner2004.par) is published with ViennaRNA but not present in this
environment, so the full Turner-2004 tables cannot be transcribed here; this
loader gives users the same escape hatch as `RNAfold -P`: point
`--param-file` at any ViennaRNA v2.0 parameter file and every table it
contains overrides the built-in set exactly.

Format: sections headed by `# <name>`, integer values (INF literal allowed),
`/* ... */` comments ignored; special-loop sections list `SEQUENCE energy
[enthalpy]` rows.  Enthalpy sections (`*_enthalpies`, dH columns) are parsed
and discarded — folding here is at 37C only, matching the reference usage.

Pair-type order in files: CG GC GU UG AU UA NN (mapped to rows 1..7 of the
internal (8, ...) tables, row 0 = no-pair); base order: N A C G U.

Copied from the JAX package's module of the same name, on top of the
port's own `energy_params`: importing any `dafs_tpu` module imports JAX
(its package `__init__` does), and the port must run where JAX is not
installed.
"""

from __future__ import annotations

import re

import numpy as np

from dafs_tpu_torch.ops import energy_params as ep

INF_VALUE = ep.INF

# section name -> (params() key, shape of the 1..7 / 0..4 slice it fills)
_TABLE_SECTIONS = {
    "stack": ("stack", (7, 7)),
    "mismatch_hairpin": ("mismatchH", (7, 5, 5)),
    "mismatch_interior": ("mismatchI", (7, 5, 5)),
    "mismatch_interior_1n": ("mismatch1nI", (7, 5, 5)),
    "mismatch_interior_23": ("mismatch23I", (7, 5, 5)),
    "mismatch_multi": ("mismatchM", (7, 5, 5)),
    "mismatch_exterior": ("mismatchExt", (7, 5, 5)),
    "dangle5": ("dangle5", (7, 5)),
    "dangle3": ("dangle3", (7, 5)),
    "int11": ("int11", (7, 7, 5, 5)),
    "int21": ("int21", (7, 7, 5, 5, 5)),
    "int22": ("int22", (6, 6, 4, 4, 4, 4)),
    "hairpin": ("hairpin", (31,)),
    "bulge": ("bulge", (31,)),
    "interior": ("internal", (31,)),
}

_LOOP_SECTIONS = {"Triloops": 5, "Tetraloops": 6, "Hexaloops": 8}


def _tokenize(text: str) -> list[str]:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return text.split()


def load_param_file(path: str) -> dict:
    """Parse a ViennaRNA v2.0 parameter file into a params() override dict
    (energies in dcal/mol, same keys/shapes as energy_params.params())."""
    lines = open(path).read().splitlines()
    if not lines or "RNAfold parameter file v2.0" not in lines[0]:
        raise ValueError(
            f"{path}: not a ViennaRNA v2.0 parameter file "
            "(missing '## RNAfold parameter file v2.0' header)"
        )

    # split into sections
    sections: dict[str, list[str]] = {}
    name = None
    for ln in lines[1:]:
        m = re.match(r"\s*#\s*(\S+)", ln)
        if m:
            name = m.group(1)
            sections[name] = []
        elif name is not None:
            sections[name].append(ln)

    base = ep.params()
    over: dict = {}

    def ints(section: str) -> list[int]:
        out = []
        for tok in _tokenize("\n".join(sections[section])):
            if tok.upper().startswith("INF"):
                out.append(INF_VALUE)
            else:
                out.append(int(tok))
        return out

    for sec, (key, shape) in _TABLE_SECTIONS.items():
        if sec not in sections:
            continue
        vals = ints(sec)
        want = int(np.prod(shape))
        if len(vals) != want:
            raise ValueError(
                f"{path}: section '# {sec}' has {len(vals)} values, "
                f"expected {want}"
            )
        arr = np.array(vals, dtype=np.int64).reshape(shape)
        full = np.array(base[key], dtype=np.int64).copy()
        if shape == (31,):
            full = arr.astype(np.int32)
        elif sec == "int22":
            # files list canonical pairs (1..6) and real bases (1..4) only;
            # NN/N entries keep the built-in values
            full[1:7, 1:7, 1:5, 1:5, 1:5, 1:5] = arr
        elif shape[0] == 7 and len(shape) >= 2 and shape[1] == 7:
            full[1:8, 1:8] = arr
        else:
            full[1:8] = arr
        over[key] = full.astype(np.int32)

    for sec, k in _LOOP_SECTIONS.items():
        if sec not in sections:
            continue
        d = {}
        for ln in sections[sec]:
            parts = ln.split()
            if len(parts) >= 2 and re.fullmatch(r"[ACGU]+", parts[0]):
                if len(parts[0]) != k:
                    raise ValueError(
                        f"{path}: '# {sec}' row '{ln.strip()}' has a "
                        f"{len(parts[0])}-mer, expected {k} (closing pair "
                        "+ loop bases)"
                    )
                d[parts[0]] = int(parts[1])
        over[{"Triloops": "triloops", "Tetraloops": "tetraloops",
              "Hexaloops": "hexaloops"}[sec]] = d

    if "ML_params" in sections:
        v = ints("ML_params")
        if len(v) != 6:
            raise ValueError(f"{path}: '# ML_params' needs 6 values, got {len(v)}")
        over["ml_base"], over["ml_closing"], over["ml_intern"] = v[0], v[2], v[4]
    if "NINIO" in sections:
        v = ints("NINIO")
        if len(v) != 3:
            raise ValueError(f"{path}: '# NINIO' needs 3 values, got {len(v)}")
        over["ninio"], over["max_ninio"] = v[0], v[2]
    if "Misc" in sections:
        v = ints("Misc")
        if len(v) < 4:
            raise ValueError(f"{path}: '# Misc' needs >=4 values, got {len(v)}")
        over["terminal_au"] = v[2]

    return over


def apply_param_file(path: str) -> dict:
    """Load `path` and install it as the active parameter override set."""
    over = load_param_file(path)
    ep.set_param_overrides(over)
    return over
