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
diag-major planes, `sc_pow`, `SCP`, `bs_seg`, `gate_u`, and the flat tables
and scalars concatenated into one buffer (`pack`).  So every pow, exp and
table lookup is rounded once, by the same torch ops; the kernels multiply,
add and divide.  `call_inputs` adds what no ladder attempt's scale changes,
built on the device once a call: the A-group channels repacked a record a
cell (a float4 a sequence), the pair codes as bytes beside them, the
per-sequence letters as bytes and gap counts as shorts, and the compact
list of pair-allowed cells by diagonal.  `INSIDE` and `OUTSIDE` are one
cooperative launch a call each (a grid barrier between the diagonals),
`EXTERIOR` one launch.
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
BARRIER_PROBE = cuda_lib.CudaKernel("dafs_alifold_barrier_probe", [ctypes.c_int, ctypes.c_int])

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

# The code planes of `prepare`, in the order of `codes`' slots (uint8: the
# types are 0..6, the codes below 175).
CODES = ("TP7L", "C175_OUTL", "C35_OUTL", "RT7L", "C175_INL", "C35_INL")
# The input tensors of `csrc/alifold.cu`'s AlifoldArgs, in its field order:
# (field, the prepared tensors it holds, dtype, shape kind).  Shape kinds:
# "rec" (a float4 record of NS sequences a diag-major cell), "codes" (six
# bytes of NS sequences a cell), "ld" (one diag-major plane), "sq" (Lp,
# Lp), "vec" (Lp,), "pow" (Lp + 1,), "scp" (31, 31), "big" (NS, PAD + 2 Lp
# + PAD).  The fields of CALL (`call_inputs`) are the same on every ladder
# attempt of a call.
INPUTS = (
    ("in_rec", ("IN_ST",), torch.float32, "rec"), ("out_rec", ("OUT_ST",), torch.float32, "rec"),
    ("codes", CODES, torch.uint8, "codes"),
    ("hp", ("HPL",), torch.float32, "ld"), ("mlstem", ("MLSTEML",), torch.float32, "ld"),
    ("mlclose", ("MLCLOSEL",), torch.float32, "ld"), ("psc", ("PSCL",), torch.float32, "ld"),
    ("ap", ("APL",), torch.float32, "ld"), ("ext", ("EXT",), torch.float32, "sq"),
    ("bs_seg", ("bs_seg",), torch.float32, "sq"), ("gate_u", ("gate_u",), torch.float32, "vec"),
    ("sc_pow", ("sc_pow",), torch.float32, "pow"), ("scp", ("SCP",), torch.float32, "scp"),
    ("s5b", ("S5b",), torch.uint8, "big"), ("s3b", ("S3b",), torch.uint8, "big"),
    ("a2sb", ("A2Sb",), torch.int16, "big"),
)
CALL = ("in_rec", "out_rec", "codes", "s5b", "s3b", "a2sb", "pairs", "pair_off")
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
        + [(f, ctypes.c_void_p) for f in ("tabs", "cells", "pairs", "pair_off")]
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
    return {"rec": (*ld, NS, 4), "codes": (*ld, len(CODES), NS), "ld": ld, "sq": (Lp, Lp),
            "vec": (Lp,), "pow": (Lp + 1,), "scp": (ak.SW, ak.SW),
            "big": (NS, 2 * ak.PAD + 2 * Lp), "one": (1,)}


def pair_lists(apl: torch.Tensor, n: int):
    """The compact list of pair-allowed cells, on `apl`'s device: (pairs,
    pair_off), int32; diagonal d's cells (d > TURN, 1 <= i <= n - d, ap > 0)
    are pairs[pair_off[d] : pair_off[d + 1]], i ascending."""
    dev, C0 = apl.device, ak.SW + 2
    d = torch.arange(n + 1, device=dev)[:, None]
    i = torch.arange(n + 1, device=dev)[None, :]
    body = apl[ak.RP : ak.RP + n + 1, C0 : C0 + n + 1]   # [d, i] = ap[i][i + d]
    ok = (body > 0) & (d > ak.TURN) & (i >= 1) & (i <= n - d)
    pairs = ok.nonzero()[:, 1].to(torch.int32)            # row-major: by d, then i
    pair_off = torch.zeros(n + 2, dtype=torch.int64, device=dev)
    pair_off[1:] = torch.cumsum(ok.sum(dim=1), dim=0)
    return pairs.contiguous(), pair_off[: n + 1].to(torch.int32).contiguous()


def call_inputs(p: dict, n: int) -> dict:
    """The kernels' inputs that no ladder attempt's scale changes (CALL), on
    the prepared tensors' device: the A-group channels a record a cell
    ((nrows, wc, NS, 4): a cell's sequences one after another, a sequence's
    four channels side by side), the six code planes as bytes beside them
    ((nrows, wc, 6, NS)), the per-sequence letters as bytes and gap counts
    as shorts, and the compact list of pair-allowed cells.  Moves and
    narrows values; rounds nothing."""
    NS, nrows, wc = p["NS"], p["NROWS"], p["WC"]

    def rec(ch):   # (4 NS, nrows, wc) -> (nrows, wc, NS, 4)
        return ch.view(4, NS, nrows, wc).permute(2, 3, 1, 0).contiguous()

    out = {"in_rec": rec(p["IN_ST"]), "out_rec": rec(p["OUT_ST"]),
           "codes": torch.stack([p[k].to(torch.uint8) for k in CODES]).permute(2, 3, 0, 1)
           .contiguous(),
           "s5b": p["S5b"].to(torch.uint8), "s3b": p["S3b"].to(torch.uint8),
           "a2sb": p["A2Sb"].to(torch.int16)}
    out["pairs"], out["pair_off"] = pair_lists(p["APL"], n)
    return out


def pack(p: dict, n: int, bcut: int, call: dict | None = None) -> dict:
    """The kernels' arguments from a `prepare`d consensus, on its device:
    `tensors` (the inputs by field, `tabs`, `cells`, the compact list and
    the zeroed state) and `ints` (sizes and the flat tables' offsets).
    `call`: `call_inputs(p, n)` of an earlier attempt of the same call
    (built here when None).  Builds no CUDA call, so the CPU tests check
    it."""
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
    tensors = dict(call if call is not None else call_inputs(p, n))
    for field, names, _, _ in INPUTS:
        if field not in CALL:
            tensors[field] = p[names[0]]
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
    cuda_lib.check(t["pairs"], "pairs", torch.int32, (t["pairs"].numel(),), dev)
    cuda_lib.check(t["pair_off"], "pair_off", torch.int32, (ints["n"] + 1,), dev)
    for field, kind in STATE:
        cuda_lib.check(t[field], field, torch.float32, sh[kind], dev)
    args = AlifoldArgs()
    for field, *_ in INPUTS:
        setattr(args, field, t[field].data_ptr())
    for field in ("tabs", "cells", "pairs", "pair_off", *(f for f, _ in STATE)):
        setattr(args, field, t[field].data_ptr())
    for field, value in ints.items():
        setattr(args, field, value)
    return args


def _launch(kernel, pk, args):
    with torch.cuda.device(pk["tensors"]["psc"].device):  # this card's stream
        kernel(ctypes.addressof(args))


def inside(pk: dict, args: AlifoldArgs) -> None:
    """qb, qm1 and qm of every cell: one cooperative launch, diagonal by
    diagonal behind grid barriers."""
    _launch(INSIDE, pk, args)


def exterior(pk: dict, args: AlifoldArgs) -> None:
    """q1, qn and Q from the inside's qb."""
    _launch(EXTERIOR, pk, args)


def outside(pk: dict, args: AlifoldArgs) -> None:
    """pout of every cell: one cooperative launch, diagonal by diagonal;
    the multiloop accumulators start from zero."""
    pk["tensors"]["a1t"].zero_()
    pk["tensors"]["a2t"].zero_()
    _launch(OUTSIDE, pk, args)


def inside_outside(p: dict, n: int, *, BCUT: int = ak.SW, call: dict | None = None):
    """The consensus on a `prepare`d input on the card: (pout (Lp, Lp), Q
    (0-d)), as `alifold_kernel.inside_outside` returns them.  `call` as
    for `pack`."""
    pk = pack(p, n, BCUT, call)
    args = launch_args(pk)
    inside(pk, args)
    exterior(pk, args)
    outside(pk, args)
    t = pk["tensors"]
    return t["pout"], t["q"].reshape(())


def call_loops():
    """`inside_outside` for the ladder attempts of one consensus call: the
    inputs no attempt's scale changes (`call_inputs`: the repacked records
    and codes and the compact list) are built at the first attempt and
    read by the later ones."""
    call = {}

    def loops(p, n, *, BCUT=ak.SW):
        if not call:
            call.update(call_inputs(p, n))
        return inside_outside(p, n, BCUT=BCUT, call=call)

    return loops


def grid(pk: dict, args: AlifoldArgs, outside_scan: bool = False) -> int:
    """The CTAs of the inside's (or the outside's) cooperative launch for
    these arguments on their card."""
    lib = cuda_lib.library()
    out = ctypes.c_int(0)
    with torch.cuda.device(pk["tensors"]["psc"].device):
        err = lib.dafs_alifold_grid(ctypes.c_void_p(ctypes.addressof(args)),
                                    ctypes.c_int(int(outside_scan)), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"dafs_alifold_grid: CUDA error {err}: "
                           f"{lib.dafs_error_string(err).decode()}")
    return out.value


def barrier_probe(pk: dict, args: AlifoldArgs, steps: int) -> None:
    """One cooperative launch on the inside's grid for these arguments that
    passes `steps` grid barriers and computes nothing: the scans' floor,
    for timing (a scan of n columns passes n - 1)."""
    blocks = grid(pk, args)
    with torch.cuda.device(pk["tensors"]["psc"].device):
        BARRIER_PROBE(blocks, steps)


def floor_probe(dev, launches: int) -> None:
    """`launches` empty launches one after another on `dev`'s stream: the
    floor of a launch a diagonal (2 (n - 1) + 1 dependent launches a
    call), for timing."""
    with torch.cuda.device(dev):
        FLOOR_PROBE(launches, launches=launches)
