"""CUDA kernels of the McCaskill fold: the inside, exterior and outside of
one length bucket (`csrc/mccaskill.cu`).

They replace `dafs_tpu`'s device program for the fold,
`dafs_tpu/ops/mccaskill_kernel.py::mccaskill_fast` (:51; vmapped and jitted
by `dafs_tpu/ops/mccaskill.py::_batched_fast` :577); the source and its
design notes are in `csrc/mccaskill.cu`.  The plain PyTorch version is
`ops/mccaskill_kernel.mccaskill_fast`, which `ops/mccaskill.fold_attempt`
takes for CPU tensors.  These wrappers accept CUDA tensors only.

`prepare` builds, on the bucket's device with torch ops and once a bucket,
what no ladder attempt's scale changes: the per-cell factors (the stencil's
F and G of `mccaskill_kernel.side_factors`, the hairpin without its scale,
the multiloop stem and closing factors, `exterior_factor`'s ext), the pair
codes as bytes, the letters, the blocked-position prefix, the compact list
of pair-allowed cells by diagonal, the stencil slots and the loop tables.
`pack` adds what an attempt's scale sets (`bs_segments`, sc ** k, each
slot's constant times sc ** (u + v + 2)) and the zeroed state.  `INSIDE`
and `OUTSIDE` are one cooperative launch an attempt each (a grid barrier
between the diagonals), `EXTERIOR` one launch.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib
from dafs_tpu_torch.ops import energy_params as ep
from dafs_tpu_torch.ops import mccaskill_kernel as MK

_P = ctypes.c_void_p

INSIDE = cuda_lib.CudaKernel("dafs_mccaskill_inside", [_P])
EXTERIOR = cuda_lib.CudaKernel("dafs_mccaskill_exterior", [_P])
OUTSIDE = cuda_lib.CudaKernel("dafs_mccaskill_outside", [_P])
BARRIER_PROBE = cuda_lib.CudaKernel("dafs_mccaskill_barrier_probe", [ctypes.c_int, ctypes.c_int])

SW = MK.SW
TURN = MK.TURN
SPAD = 4          # the letters' zero columns before S[0] and after S[Lp - 1]
# A cell's factors, in `cellf`'s last dimension (csrc/mccaskill.cu's enum).
FACTORS = ("F_gen", "F_1n", "F_23", "F_tau", "G_gen", "G_1n", "G_23", "G_tau",
           "hp0", "stem", "close", "ext")
CATEGORIES = ("gen", "1n", "23", "tau")
# The special stencil slots, a lane each in the kernels: stack, the two
# 1-bulges, 1x1, 1x2, 2x1, 2x2.
SPECIAL = ((0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))
# The flat table buffer, in buffer order: (offset field, `_fast_tabs` key).
TABLES = (("o_stack", "stack"), ("o_i11", "i11"), ("o_i21", "i21"), ("o_i22", "i22"))

# The fields of csrc/mccaskill.cu's McArgs, in its order: (field, dtype,
# shape kind).  Shape kinds: "cellf" (B, Lp, Lp, 12), "sq" (B, Lp, Lp), "sq4"
# (B, Lp, Lp, 4), "seq" (B, Lp + 2 SPAD), "vec" (B, Lp), "b" (B,), "off"
# (maxn + 1,), "slots" (nslots,), "scs" (B, 31), "pow" (B, Lp + 1), "kslot"
# (B, nslots), "pairs" and "tabs" their own length.
BUCKET = (
    ("cellf", torch.float32, "cellf"), ("code", torch.uint8, "sq"), ("seq", torch.int32, "seq"),
    ("blk", torch.int32, "vec"), ("gate_u", torch.float32, "vec"), ("nlen", torch.int32, "b"),
    ("pairs", torch.int32, "pairs"), ("pair_off", torch.int32, "off"),
    ("slots", torch.int32, "slots"), ("tabs", torch.float32, "tabs"),
)
ATTEMPT = (
    ("sc", "b"), ("bs", "b"), ("scs", "scs"), ("sc_pow", "pow"), ("kslot", "kslot"),
    ("bs_seg", "sq"),
)
# The kernels' state and outputs, all float32 and zeroed at each attempt.
STATE = (
    ("qbl", "sq"), ("ql", "sq4"), ("qbx", "sq"), ("qbxt", "sq"), ("qm", "sq"), ("qm1t", "sq"),
    ("q1", "vec"), ("qn", "vec"), ("q", "b"), ("cl", "sq"), ("clc", "sq4"), ("cm", "sq"),
    ("a1", "sq"), ("a2", "sq"), ("pout", "sq"),
)
INTS = ("nb", "lp", "maxn", "nslots", "s_1n", "s_23", "s_tau",
        *(f for f, _ in TABLES), "o_bulge1")


class McArgs(ctypes.Structure):
    """`csrc/mccaskill.cu`'s McArgs: the pointers, then the ints."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f, _, _ in BUCKET]
        + [(f, ctypes.c_void_p) for f, _ in ATTEMPT]
        + [(f, ctypes.c_void_p) for f, _ in STATE]
        + [(f, ctypes.c_int) for f in INTS]
    )


def category(u: int, v: int) -> str | None:
    """The loop category of stencil slot (u, v) (`mccaskill._fast_tabs`'s
    masks), None for a special slot or one past MAXLOOP."""
    if (u, v) in SPECIAL or u + v > SW - 1:
        return None
    if u == 0 or v == 0:
        return "tau"
    if (u == 1 and v >= 3) or (v == 1 and u >= 3):
        return "1n"
    if (u, v) in ((2, 3), (3, 2)):
        return "23"
    return "gen"


def stencil_slots() -> list[tuple[int, int, str]]:
    """The non-special stencil slots (u, v, category) in the kernels' order:
    by category (CATEGORIES), then u + v, then u."""
    slots = [(u, s - u, category(u, s - u)) for s in range(SW) for u in range(s + 1)]
    slots = [c for c in slots if c[2] is not None]
    return sorted(slots, key=lambda c: (CATEGORIES.index(c[2]), c[0] + c[1], c[0]))


def cell_factors(S, pt, blocked, codes, t):
    """The scale-free per-cell factors that the plain version forms a
    diagonal at a time, as (B, Lp, Lp) matrices: hp0, the hairpin of pair
    (i, j) without its scale sc ** (d + 1) (0 where it cannot close a
    hairpin), stem (the multiloop stem factor of (i, j)) and close (its
    closing factor).  S, pt long; blocked = `blocked_prefix`."""
    B, Lp = S.shape
    dev = S.device
    ii = torch.arange(Lp, device=dev)
    i_g, j_g = ii[:, None], ii[None, :]
    RT = torch.as_tensor(ep.RTYPE, device=dev).long()

    def at(idx):   # S[:, idx], 0 outside [0, Lp - 1] (the plain version's S_big)
        ok = (idx >= 0) & (idx <= Lp - 1)
        return torch.where(ok, S[:, idx.clamp(0, Lp - 1)], 0)

    si1 = S[:, (i_g + 1).clamp(0, Lp - 1)]      # S[i+1]  (B, Lp, 1)
    sim1 = S[:, (i_g - 1).clamp(0, Lp - 1)]     # S[i-1]
    sj1 = at(j_g - 1)                            # S[j-1]  (B, 1, Lp)
    sjp1 = at(j_g + 1)                           # S[j+1]
    rt = RT[pt]
    stem = t["mmM"][pt, sim1, sjp1] * MK.tau_factor(pt, t) * t["mli"]
    close = t["mmM"][rt, sj1, si1] * MK.tau_factor(rt, t) * t["mli"] * t["mlc"]

    # the hairpin's loop factor by d = j - i (loop size d - 1), extrapolated
    # past MAXLOOP as the plain version does, one diagonal at a time
    dd = torch.arange(Lp, device=dev)
    size = dd - 1
    base = t["hairpin"][size.clamp(0, MK.MAXLOOP)]
    ratio = size.clamp(min=1).to(torch.float32) / 30.0
    base = torch.where(size > MK.MAXLOOP, base * t["lxc"] ** torch.log(ratio), base)
    d_g = (j_g - i_g).clamp(min=0)
    base, size = base[d_g], size[d_g]                             # (Lp, Lp)
    mmh = t["mmH"][pt, si1, sj1]
    tri_code, tetra_code, hexa_code = (c.long()[:, :, None] for c in codes)
    tri, tetra, hexa = t["tri"][tri_code], t["tetra"][tetra_code], t["hexa"][hexa_code]
    hp_val = torch.where(
        size == 3, torch.where(tri >= 0, tri, base * MK.tau_factor(pt, t)),
        torch.where(size == 4, torch.where(tetra >= 0, tetra, base * mmh),
                    torch.where(size == 6, torch.where(hexa >= 0, hexa, base * mmh),
                                base * mmh)))
    pref_j1 = torch.where(j_g - 1 <= Lp - 1, blocked[:, (j_g - 1).clamp(0, Lp - 1)], 1e9)
    hp_open = (pref_j1 - blocked[:, :, None]) == 0.0
    hp0 = torch.where(hp_open & (size >= 3) & (j_g > i_g), hp_val, 0.0)
    return hp0, stem, close


def pair_lists(allow_pair, n, maxn):
    """The compact list of pair-allowed cells, on the tensors' device: (pairs,
    pair_off), int32; diagonal d's cells (d > TURN, 1 <= i <= n_b - d, allowed)
    are pairs[pair_off[d] : pair_off[d + 1]] as b << 16 | i, by b, then i."""
    B, Lp, _ = allow_pair.shape
    dev = allow_pair.device
    d = torch.arange(maxn + 1, device=dev)[:, None]
    i = torch.arange(Lp, device=dev)[None, :]
    j = i + d
    ap = allow_pair[:, i.expand(maxn + 1, Lp), j.clamp(max=Lp - 1)]   # (B, d, i)
    ok = ap & (j <= Lp - 1) & (d > TURN) & (i >= 1) & (j <= n.long()[:, None, None])
    ok = ok.permute(1, 0, 2)                                          # (d, b, i)
    idx = ok.nonzero()
    pairs = (idx[:, 1] * 65536 + idx[:, 2]).to(torch.int32)
    pair_off = torch.zeros(maxn + 1, dtype=torch.int64, device=dev)
    pair_off[1:] = torch.cumsum(ok.sum(dim=(1, 2)), dim=0)[:maxn]
    return pairs.contiguous(), pair_off.to(torch.int32).contiguous()


def prepare(S, pt, allow_pair, allow_unpaired, n, codes, tabs) -> dict:
    """What the kernels read of one bucket that no ladder attempt changes,
    built on the tensors' device (the arguments are `mccaskill_fast`'s).
    Builds no CUDA call, so the CPU tests check it."""
    dev = S.device
    B, Lp = S.shape
    if B >= 32768 or Lp >= 65536:
        raise ValueError(f"mccaskill_cuda: {B} sequences of padded length {Lp} do not fit the "
                         "pair list's b << 16 | i")
    S, pt, t = S.long(), pt.long(), tabs
    blocked = MK.blocked_prefix(allow_unpaired, n)
    fac = MK.side_factors(S, pt, t)
    hp0, stem, close = cell_factors(S, pt, blocked, codes, t)
    fac.update(hp0=hp0, stem=stem, close=close, ext=MK.exterior_factor(S, pt, n, t))
    cellf = torch.stack([fac[k] for k in FACTORS], dim=-1).contiguous()
    RT = torch.as_tensor(ep.RTYPE, device=dev).long()
    code = (pt | (RT[pt] << 3) | (allow_pair.long() << 6)).to(torch.uint8)
    seq = torch.zeros((B, Lp + 2 * SPAD), dtype=torch.int32, device=dev)
    seq[:, SPAD : SPAD + Lp] = S.to(torch.int32)
    maxn = int(n.max()) if B else 0
    pairs, pair_off = pair_lists(allow_pair, n, maxn)
    slots = stencil_slots()
    cat, u, v = (torch.tensor(x, device=dev) for x in
                 zip(*[(CATEGORIES.index(c), u, v) for u, v, c in slots]))
    cslot = torch.stack([t[f"C_{c}"] for c in CATEGORIES])[cat, u, u + v]
    flat = [t[k].reshape(-1) for _, k in TABLES] + [t["bulge"][1].reshape(1)]
    ints = {"nb": B, "lp": Lp, "maxn": maxn, "nslots": len(slots)}
    for k, c in enumerate(CATEGORIES[1:]):
        ints[f"s_{c}"] = next(x for x, s in enumerate(slots) if CATEGORIES.index(s[2]) > k)
    off = 0
    for (field, _), part in zip(TABLES, flat):
        ints[field] = off
        off += part.numel()
    ints["o_bulge1"] = off
    seg_len, seg_ok = MK.segments(blocked)
    return {
        "dev": dev, "ints": ints, "mlb": t["mlb"], "seg_len": seg_len, "seg_ok": seg_ok,
        "cslot": cslot, "slot_s": u + v,
        "tensors": {
            "cellf": cellf, "code": code.contiguous(), "seq": seq,
            "blk": blocked.to(torch.int32).contiguous(),
            "gate_u": allow_unpaired.to(torch.float32).contiguous(),
            "nlen": n.to(torch.int32).contiguous(), "pairs": pairs, "pair_off": pair_off,
            "slots": (u | v << 8).to(torch.int32),
            "tabs": torch.cat(flat).to(torch.float32).contiguous(),
        },
    }


def shapes(ints: dict, npairs: int, ntabs: int) -> dict:
    """The shape of each shape kind of a `prepare`d bucket."""
    B, Lp = ints["nb"], ints["lp"]
    return {"cellf": (B, Lp, Lp, len(FACTORS)), "sq": (B, Lp, Lp), "sq4": (B, Lp, Lp, 4),
            "seq": (B, Lp + 2 * SPAD), "vec": (B, Lp), "b": (B,), "off": (ints["maxn"] + 1,),
            "slots": (ints["nslots"],), "scs": (B, SW), "pow": (B, Lp + 1),
            "kslot": (B, ints["nslots"]), "pairs": (npairs,), "tabs": (ntabs,)}


def pack(prep: dict, sc: torch.Tensor) -> dict:
    """The kernels' arguments for one ladder attempt at per-sequence scales
    `sc` (B,) float32: the bucket's tensors, what the scale sets (bs, bs_seg,
    sc ** (s + 2) as the plain version's sc_pow, sc ** k, the slots'
    constants times sc ** (u + v + 2) as the plain version's contraction
    forms them) and the zeroed state.  Builds no CUDA call."""
    dev, ints = prep["dev"], prep["ints"]
    B, Lp = ints["nb"], ints["lp"]
    f32 = torch.float32
    tensors = dict(prep["tensors"])
    bs = prep["mlb"] * sc
    scs = sc[:, None] ** (torch.arange(SW, device=dev).to(f32) + 2.0)
    tensors.update(
        sc=sc.contiguous(), bs=bs.contiguous(), scs=scs.contiguous(),
        sc_pow=(sc[:, None] ** torch.arange(Lp + 1, device=dev).to(f32)).contiguous(),
        kslot=(prep["cslot"][None, :] * scs[:, prep["slot_s"]]).contiguous(),
        bs_seg=MK.bs_segments(prep["seg_len"], prep["seg_ok"], bs).contiguous(),
    )
    sh = shapes(ints, tensors["pairs"].numel(), tensors["tabs"].numel())
    # one buffer, each part starting on 64 bytes (ql and clc are read and
    # written as float4)
    sizes = [torch.Size(sh[kind]).numel() for _, kind in STATE]
    spans = [-(-k // 16) * 16 for k in sizes]
    buf = torch.zeros(sum(spans), dtype=f32, device=dev)
    for (field, kind), part, k in zip(STATE, torch.split(buf, spans), sizes):
        tensors[field] = part[:k].view(sh[kind])
    return dict(tensors=tensors, ints=ints)


def launch_args(pk: dict) -> McArgs:
    """The McArgs of a `pack`, after checking every tensor: CUDA, one
    device, contiguous, of its dtype and shape."""
    t, ints = pk["tensors"], pk["ints"]
    dev = t["cellf"].device
    if dev.type != "cuda":
        raise ValueError(f"mccaskill_cuda: expected CUDA tensors, got {dev}")
    sh = shapes(ints, t["pairs"].numel(), t["tabs"].numel())
    for field, dtype, kind in BUCKET:
        cuda_lib.check(t[field], field, dtype, sh[kind], dev)
    for field, kind in ATTEMPT:
        cuda_lib.check(t[field], field, torch.float32, sh[kind], dev)
    for field, kind in STATE:
        cuda_lib.check(t[field], field, torch.float32, sh[kind], dev)
        if kind == "sq4" and t[field].data_ptr() % 16:
            raise ValueError(f"{field}: expected a 16-byte aligned tensor (read as float4)")
    args = McArgs()
    for field, *_ in (*BUCKET, *ATTEMPT, *STATE):
        setattr(args, field, t[field].data_ptr())
    for field in INTS:
        setattr(args, field, ints[field])
    return args


def _launch(kernel, pk, args):
    with torch.cuda.device(pk["tensors"]["cellf"].device):  # this card's stream
        kernel(ctypes.addressof(args))


def inside(pk: dict, args: McArgs) -> None:
    """qb, qm1 and qm of every cell: one cooperative launch, diagonal by
    diagonal behind grid barriers."""
    _launch(INSIDE, pk, args)


def exterior(pk: dict, args: McArgs) -> None:
    """q1, qn and Q of every sequence from the inside's qb ext."""
    _launch(EXTERIOR, pk, args)


def outside(pk: dict, args: McArgs) -> None:
    """pout of every cell: one cooperative launch, diagonal by diagonal;
    the multiloop accumulators start from zero."""
    pk["tensors"]["a1"].zero_()
    pk["tensors"]["a2"].zero_()
    _launch(OUTSIDE, pk, args)


def mccaskill(prep: dict, sc: torch.Tensor):
    """One ladder attempt of a `prepare`d bucket on the card: (pout (B, Lp,
    Lp), Q (B,)), as `mccaskill_kernel.mccaskill_fast` returns them."""
    pk = pack(prep, sc)
    args = launch_args(pk)
    inside(pk, args)
    exterior(pk, args)
    outside(pk, args)
    return pk["tensors"]["pout"], pk["tensors"]["q"]


def grid(pk: dict, args: McArgs, outside_scan: bool = False) -> int:
    """The CTAs of the inside's (or the outside's) cooperative launch for
    these arguments on their card."""
    lib = cuda_lib.library()
    out = ctypes.c_int(0)
    with torch.cuda.device(pk["tensors"]["cellf"].device):
        err = lib.dafs_mccaskill_grid(ctypes.c_void_p(ctypes.addressof(args)),
                                      ctypes.c_int(int(outside_scan)), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"dafs_mccaskill_grid: CUDA error {err}: "
                           f"{lib.dafs_error_string(err).decode()}")
    return out.value


def barrier_probe(pk: dict, args: McArgs, steps: int) -> None:
    """One cooperative launch on the inside's grid for these arguments that
    passes `steps` grid barriers and computes nothing: the scans' floor,
    for timing (a scan of a bucket passes maxn - 1)."""
    blocks = grid(pk, args)
    with torch.cuda.device(pk["tensors"]["cellf"].device):
        BARRIER_PROBE(blocks, steps)
