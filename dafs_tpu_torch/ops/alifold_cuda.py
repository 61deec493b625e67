"""CUDA kernels of the RNAalifold consensus: the inside, exterior and
outside of a `prepare`d consensus (`ops/alifold_kernel.py`).

They replace `dafs_tpu`'s device program for the consensus,
`dafs_tpu/ops/alifold_kernel.py::alifold_fast` (:437; its scans at :938,
:957, :973 and :1214); the source and its design notes are in
`csrc/alifold.cu`.  The plain PyTorch version is
`ops/alifold_kernel.inside_outside` (with `inside`, `exterior` and
`outside`), which `ops/alifold.Alifold.consensus` takes for CPU tensors.
These wrappers accept CUDA tensors only.

The kernels read the tensors `alifold_kernel.prepare` builds: the
diag-major planes, the per-sequence vectors, `sc_pow`, `SCP`, `bs_seg`,
`gate_u`, and the flat tables and scalars concatenated into one buffer
(`pack`).  So every pow, exp and table lookup is rounded once, by the same
torch ops; the kernels multiply, add and divide.  `INSIDE` launches once a
diagonal (n - 1 launches), `EXTERIOR` once, `OUTSIDE` once a diagonal.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import alifold_kernel as ak
from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p

INSIDE = cuda_lib.CudaKernel("dafs_alifold_inside", [_P])
EXTERIOR = cuda_lib.CudaKernel("dafs_alifold_exterior", [_P])
OUTSIDE = cuda_lib.CudaKernel("dafs_alifold_outside", [_P])
FLOOR_PROBE = cuda_lib.CudaKernel("dafs_alifold_floor_probe", [ctypes.c_int])

# The flat table buffer: (field, prepared tensor) in buffer order; then the
# scalars.  T7 [tp*7 + tp2], Ti11 [c175*7 + t2], Ti21a [c175*35 + m35],
# Ti21b [(c35*5 + p)*35 + m35], Ti22 [(c175*5 + p)*35 + m35], Ti21b_o
# [c35*175 + c175_in], Ti22_o [c175*175 + c175_in], T_gen [u1*31 + u2].
TABLES = (
    ("o_t7", "T7f"), ("o_ti11", "Ti11f"), ("o_ti21a", "Ti21af"), ("o_ti21b", "Ti21bf"),
    ("o_ti22", "Ti22f"), ("o_ti21b_o", "Ti21b_of"), ("o_ti22_o", "Ti22_of"),
    ("o_tgen", "TGENf"), ("o_bu", "BU"), ("o_f1n", "F1N"),
    ("o_c23", "C23"), ("o_blg1", "blg1"), ("o_sc", "sc_t"), ("o_bsn", "bsn"),
)

# The input tensors of `csrc/alifold.cu`'s AlifoldArgs, in its field order:
# (field, prepared tensor, dtype, shape kind).  Shape kinds: "ch4" (4 NS
# diag-major planes), "seq" (NS diag-major planes), "ld" (one diag-major
# plane), "sq" (Lp, Lp), "vec" (Lp,), "pow" (Lp + 1,), "scp" (31, 31),
# "big" (NS, PAD + 2 Lp + PAD).
INPUTS = (
    ("in_st", "IN_ST", torch.float32, "ch4"), ("out_st", "OUT_ST", torch.float32, "ch4"),
    ("tp7", "TP7L", torch.int64, "seq"), ("rt7", "RT7L", torch.int64, "seq"),
    ("c175o", "C175_OUTL", torch.int64, "seq"), ("c35o", "C35_OUTL", torch.int64, "seq"),
    ("c175i", "C175_INL", torch.int64, "seq"), ("c35i", "C35_INL", torch.int64, "seq"),
    ("hp", "HPL", torch.float32, "ld"), ("mlstem", "MLSTEML", torch.float32, "ld"),
    ("mlclose", "MLCLOSEL", torch.float32, "ld"), ("psc", "PSCL", torch.float32, "ld"),
    ("ap", "APL", torch.float32, "ld"), ("ext", "EXT", torch.float32, "sq"),
    ("bs_seg", "bs_seg", torch.float32, "sq"), ("gate_u", "gate_u", torch.float32, "vec"),
    ("sc_pow", "sc_pow", torch.float32, "pow"), ("scp", "SCP", torch.float32, "scp"),
    ("s5b", "S5b", torch.int64, "big"), ("s3b", "S3b", torch.int64, "big"),
    ("a2sb", "A2Sb", torch.int64, "big"),
)
# The kernels' state and outputs, in field order, all float32 and zeroed
# at the start of a call: diag-major planes or (Lp, Lp), (Lp,), (1,).
STATE = (
    ("qbl", "ld"), ("cl", "ld"), ("cm", "ld"), ("qm", "sq"), ("qm1t", "sq"),
    ("a1t", "sq"), ("a2t", "sq"), ("q1", "vec"), ("qn", "vec"), ("q", "one"),
    ("pout", "sq"),
)
INTS = ("ns", "lp", "n", "nrows", "wc", "wb", "bcut", "ncells")


class AlifoldArgs(ctypes.Structure):
    """`csrc/alifold.cu`'s AlifoldArgs: the pointers, then the ints."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f, *_ in INPUTS]
        + [("tabs", ctypes.c_void_p), ("cells", ctypes.c_void_p)]
        + [(f, ctypes.c_void_p) for f, _ in STATE]
        + [(f, ctypes.c_int) for f in INTS]
        + [(f, ctypes.c_int) for f, _ in TABLES]
    )


def stencil_cells() -> list[tuple[int, int]]:
    """The (u, v) cells of the STAIR blocks, every one the plain version
    evaluates, in the kernels' thread order: by u + v, then u (neighbouring
    threads read neighbouring columns of a diag-major plane)."""
    cells = [(u, v) for v0, v1, u_ext in ak.STAIR for v in range(v0, v1) for u in range(u_ext)]
    return sorted(cells, key=lambda c: (c[0] + c[1], c[0]))


def shapes(NS: int, Lp: int) -> dict:
    """The shape of each shape kind at (NS, Lp)."""
    ld = (Lp + 2 * ak.RP, Lp + 2 * (ak.SW + 2))
    return {"ch4": (4 * NS, *ld), "seq": (NS, *ld), "ld": ld, "sq": (Lp, Lp), "vec": (Lp,),
            "pow": (Lp + 1,), "scp": (ak.SW, ak.SW), "big": (NS, 2 * ak.PAD + 2 * Lp),
            "one": (1,)}


def pack(p: dict, n: int, bcut: int) -> dict:
    """The kernels' arguments from a `prepare`d consensus, on its device:
    `tensors` (the inputs by field, `tabs`, `cells` and the zeroed state)
    and `ints` (sizes and the flat tables' offsets).  Builds no CUDA call,
    so the CPU tests check it."""
    dev, NS, Lp = p["dev"], p["NS"], p["Lp"]
    flat = [p[name].reshape(-1) for _, name in TABLES]
    ints = {"ns": NS, "lp": Lp, "n": n, "nrows": p["NROWS"], "wc": p["WC"],
            "wb": p["A2Sb"].shape[1], "bcut": bcut}
    off = 0
    for (field, _), t in zip(TABLES, flat):
        ints[field] = off
        off += t.numel()
    cells = stencil_cells()
    ints["ncells"] = len(cells)
    tensors = {field: p[name] for field, name, _, _ in INPUTS}
    tensors["tabs"] = torch.cat(flat)
    tensors["cells"] = torch.tensor([u | v << 8 for u, v in cells], dtype=torch.int32,
                                    device=dev)
    sh = shapes(NS, Lp)
    sizes = [torch.Size(sh[kind]).numel() for _, kind in STATE]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    for (field, kind), part in zip(STATE, torch.split(buf, sizes)):
        tensors[field] = part.view(sh[kind])
    return dict(tensors=tensors, ints=ints)


def launch_args(pk: dict) -> AlifoldArgs:
    """The AlifoldArgs of a `pack`, after checking every tensor: CUDA, one
    device, contiguous, of its dtype and shape."""
    t, ints = pk["tensors"], pk["ints"]
    dev = t["psc"].device
    if dev.type != "cuda":
        raise ValueError(f"alifold_cuda: expected CUDA tensors, got {dev}")
    sh = shapes(ints["ns"], ints["lp"])
    for field, _, dtype, kind in INPUTS:
        cuda_lib.check(t[field], field, dtype, sh[kind], dev)
    cuda_lib.check(t["tabs"], "tabs", torch.float32, (ints["o_bsn"] + 1,), dev)
    cuda_lib.check(t["cells"], "cells", torch.int32, (ints["ncells"],), dev)
    for field, kind in STATE:
        cuda_lib.check(t[field], field, torch.float32, sh[kind], dev)
    args = AlifoldArgs()
    for field, *_ in INPUTS:
        setattr(args, field, t[field].data_ptr())
    for field in ("tabs", "cells", *(f for f, _ in STATE)):
        setattr(args, field, t[field].data_ptr())
    for field, value in ints.items():
        setattr(args, field, value)
    return args


def _launch(kernel, pk, args, launches):
    with torch.cuda.device(pk["tensors"]["psc"].device):  # this card's stream
        kernel(ctypes.addressof(args), launches=launches)


def inside(pk: dict, args: AlifoldArgs) -> None:
    """qb, qm1 and qm of every cell, diagonal by diagonal."""
    _launch(INSIDE, pk, args, max(pk["ints"]["n"] - 1, 0))


def exterior(pk: dict, args: AlifoldArgs) -> None:
    """q1, qn and Q from the inside's qb."""
    _launch(EXTERIOR, pk, args, 1)


def outside(pk: dict, args: AlifoldArgs) -> None:
    """pout of every cell, diagonal by diagonal; the multiloop accumulators
    start from zero."""
    pk["tensors"]["a1t"].zero_()
    pk["tensors"]["a2t"].zero_()
    _launch(OUTSIDE, pk, args, max(pk["ints"]["n"] - 1, 0))


def inside_outside(p: dict, n: int, *, BCUT: int = ak.SW):
    """The consensus on a `prepare`d input on the card: (pout (Lp, Lp), Q
    (0-d)), as `alifold_kernel.inside_outside` returns them."""
    pk = pack(p, n, BCUT)
    args = launch_args(pk)
    inside(pk, args)
    exterior(pk, args)
    outside(pk, args)
    t = pk["tensors"]
    return t["pout"], t["q"].reshape(())


def floor_probe(dev, launches: int) -> None:
    """`launches` empty launches one after another on `dev`'s stream: the
    kernels' dependency floor, for timing (a call of n columns makes
    2 (n - 1) + 1 dependent launches)."""
    with torch.cuda.device(dev):
        FLOOR_PROBE(launches, launches=launches)
