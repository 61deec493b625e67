#!/usr/bin/env python3
"""Times the port's CUDA kernels (`dafs_tpu_torch/csrc/`) on one NVIDIA GPU.

    python3 chip_smoke.py                   # every group
    python3 chip_smoke.py dd_step paircrf   # those groups alone

Prints the card's name and power limit, builds the kernel library (nvcc,
sm_90a) and prints `-Xptxas -v` of the fold's, the consensus's and the DD
step's kernels.  Each group times its kernels with CUDA events at the main
path's shapes, beside their plain PyTorch versions on the same inputs,
with the roofline bound of those inputs (`bound`) and, where a probe
exists, the dependency floor: `kernels` (K1, K2 and the pair-HMM
posterior kernel on RF00005's and RF00017's all pairs, K3, K4), `length`
(the long variants, the ceiling of 4096), `consensus` (the final calls of
RF00005's, RF00017's and family-50's default runs), `fold` (the settled
ladder attempt of each case of `fold_times`), `dd_step` (RF00005's layers,
family-50's first and last), `paircrf` (B 45 and 105, L 96) and
`contrafold` (one bucket replayed as a CUDA graph beside the eager run, at
RF00005's (10, 96) and contra-trna's 15 sequences).  Each
kernel's outputs where it is timed are held to its plain version's, and
the largest difference goes into its row as `max_abs_err`: bit-equal for
K1-K4, the long variants, the pair-CRF, the DD step and the CONTRAfold
graph, within rtol 2e-4
and `card_checks.agree`'s atol for the fold and the consensus.  `runs`
runs every row of `card_checks.RUNS` (the table the `cuda` tests run),
each held to its row, and reads each kernel's launches from it:
`launches` from the default runs on RF00005 and RF00017, and
`launches_by_path` from each run.

Prints the kernel table as one JSON line, `{"kernels": [...]}`, and last
`{"ok": true, ...}`; fails without a card, when the build fails, or when a
kernel or a run is not held.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from tests import card_checks
from tests.card_checks import (
    dd_layers, dd_state, family50, fold_stable_scale, nussinov_inputs, nw_inputs,
    paircrf_inputs, pairhmm_inputs, random_pairs, read_fasta, read_snapshot, refold_constraints,
    traced_fold,
)

ROOT = os.path.dirname(os.path.abspath(__file__))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, out=None):
    """Mean milliseconds per call of `fn` over `reps` calls (CUDA events),
    after one warm-up call; `out` (a list) gets the last call's result."""
    import torch

    result = fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        result = fn()
    t1.record()
    torch.cuda.synchronize()
    if out is not None:
        out.append(result)
    return t0.elapsed_time(t1) / reps


def once_ms(fn, out=None):
    """Milliseconds of one call of `fn` (CUDA events), no warm-up; `out`
    (a list) gets its result."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    result = fn()
    t1.record()
    torch.cuda.synchronize()
    if out is not None:
        out.append(result)
    return t0.elapsed_time(t1)


def queued_ms(fn, reps):
    """Mean device milliseconds of `fn` over `reps` calls queued behind a
    spin of the card (`torch.cuda._sleep`), so no host launch gap falls
    between them; (ms, host ms to queue them, spin ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(40_000_000)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - h0)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host_ms, spin.elapsed_time(t0)


# ---------------------------------------------------------------- bounds --
# The least time the card could take for a kernel's work on these inputs:
# the larger of its operations over the H100's float32 rate outside the
# tensor cores and its bytes (each input read once, each output written
# once) over the memory rate.  Work is counted within the true lengths.

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
LOG_ADD_OPS = 12  # max, min, sub, two compares, min, 3 mul + 3 add, add


def bound(ops, nbytes):
    """(bound_ms, bound_by, bound_kind) of `ops` operations and `nbytes`."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", "compute"
    return t_bytes * 1e3, "bytes", "bytes"


EXP_OPS = 14  # five compares, four multiplies, four adds, the select


def pairhmm_bound(args, kernel):
    """Forward and backward, per cell of the (l1+1) x (l2+1) grid: 4
    LOG_ADDs and 10 adds, and 7 LOG_ADDs and 12 adds (csrc/pairhmm.cu);
    bytes: the codes, and the whole padded plane written.  Posterior, per
    cell of l1 x l2: two adds, the clamp and the EXP quartic; bytes: those
    cells of fm and bm, the captures, and the whole padded posterior plane
    written."""
    c1, n1, c2, n2 = (a.cpu().numpy() for a in args)
    n1, n2 = n1.astype(np.int64), n2.astype(np.int64)
    B, imax = c1.shape
    W = c2.shape[1]
    if kernel == "pairhmm_posterior":
        cells = float((n1 * n2).sum())
        nbytes = 8 * cells + 4 * B * (9 + 2) + 4 * B * (imax - 1) * (W - 1)
        return bound(cells * (3 + EXP_OPS) + B * 2 * (2 * LOG_ADD_OPS + 3), nbytes)
    cells = float(((n1 + 1) * (n2 + 1)).sum())
    per_cell = 4 * LOG_ADD_OPS + 10 if kernel == "pairhmm_forward" else 7 * LOG_ADD_OPS + 12
    nbytes = 4 * (c1.size + c2.size + 2 * B) + 4 * B * imax * W + 4 * B * 6
    return bound(cells * per_cell, nbytes)


def nussinov_bound(lens, L):
    """One add and one compare per bifurcation term, sum over ld of
    (l - ld)(ld - 3); bytes: the upper triangle of the scores within l,
    the lengths, the score and ss."""
    ops = nbytes = 0.0
    for l in lens.cpu().numpy().astype(np.int64):
        ld = np.arange(4, max(l, 4))
        ops += 2.0 * float(((l - ld) * (ld - 3)).sum())
        nbytes += 4.0 * l * (l + 1) / 2
    B = len(lens)
    return bound(ops, nbytes + 4 * B * (2 + L))


def nw_bound(args):
    """Five operations per cell inside the envelope (add, M/X compare, the
    two maxima of the row scan and dp, the Y compare); bytes: those cells'
    scores, the envelope rows within l1, the score and al."""
    sm, envf, envl, l1, l2 = (a.cpu().numpy() for a in args)
    cells = 0.0
    for b in range(sm.shape[0]):
        rows = np.arange(1, int(l1[b]) + 1)
        width = envl[b, rows] - np.maximum(envf[b, rows], 1) + 1
        cells += float(np.maximum(width, 0).sum()) + len(rows)
    B, L1 = sm.shape[:2]
    nbytes = 4 * cells + 8 * float((l1 + 1).sum()) + 4 * B * (1 + L1)
    return bound(5 * cells, nbytes)


def max_abs_err(got, want):
    """The largest |got - want| over two tuples of tensors (0.0 where they
    hold the same values, infinities included)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        w = torch.as_tensor(w).to(g.device)
        d = torch.where(g == w, 0.0, (g.double() - w.double()).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def held(label, got, want, kinds=None):
    """max_abs_err of a kernel's outputs against its plain version's (a
    tensor or a tuple each); raises unless they are equal
    (`torch.equal`), or with `kinds` (each output's tolerance kind) within
    `card_checks.agree`'s rtol 2e-4 and atol."""
    import torch

    torch.cuda.synchronize()
    got, want = (x if isinstance(x, (tuple, list)) else (x,) for x in (got, want))
    err = max_abs_err(got, want)
    if kinds is None:
        ok = all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    else:
        ok = all(card_checks.agree(g, w, k) for g, w, k in zip(got, want, kinds))
    if not ok:
        raise AssertionError(f"{label}: the kernel differs from its plain version "
                             f"(max_abs_err {err!r})")
    return err


def row(name, source, replaces, shape, ms, plain_ms, bnd, **extra):
    """One kernel's row of the table, printed as it is made."""
    bound_ms, bound_by, bound_kind = bnd
    plain = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(f"kernel {name} {shape}: {ms:.4f} ms, plain {plain}; bound {bound_ms:.6f} ms "
          f"({bound_by}), kernel at {bound_ms / ms:.2e} of it"
          + "".join(f"; {k} {v}" for k, v in extra.items() if v is not None), flush=True)
    return dict(name=name, route="cuda", source=source, replaces=replaces, shape=shape, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bound_kind=bound_kind,
                library_ms=None, **extra)


def by_case(cases, main):
    """{kernel: row} of the case `main`, with every case's numbers under
    "by_case"; cases: [(label, {kernel: row})]."""
    keys = ("shape", "ms", "plain_ms", "path_ms", "step_ms", "step_device_ms", "bound_ms",
            "bound_by", "floor_ms", "max_abs_err")
    rows = dict(cases)[main]
    return {name: dict(r, by_case={label: {k: c[name][k] for k in keys if k in c[name]}
                                   for label, c in cases})
            for name, r in rows.items()}


# ---------------------------------------------------------------- kernels --


def pairhmm_floor(args, dev):
    """Times the pair-HMM dependency floor for this batch: as many diagonals
    as its longest pair has, the M chain and the hand-over alone, with the
    warps the passes use at this width and with one warp (no barrier)."""
    import torch

    from dafs_tpu_torch.ops import pairhmm_cuda

    B, imax = args[0].shape
    steps = int((args[1] + args[3]).max()) + 1
    nw = pairhmm_cuda.warps(imax)
    buf = torch.zeros(B * 32 * nw, dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: pairhmm_cuda.floor_probe(buf, steps, nw, B), 20)
    one = cuda_ms(lambda: pairhmm_cuda.floor_probe(buf, steps, 1, B), 20)
    print(f"kernel pairhmm floor: {steps} diagonals of two dependent LOG_ADDs and the "
          f"hand-over, B={B}: {ms:.4f} ms with {nw} warps and a barrier, "
          f"{one:.4f} ms with one warp and none")
    return ms


def nussinov_floor(dev):
    """Times K3's dependency floor at (8, 352): 351 cluster barriers, each
    after one dependent L2 round trip, on a cluster of the size the
    wrapper picks there."""
    import torch

    from dafs_tpu_torch.ops import nussinov_cuda

    buf = torch.zeros(64 * 32, dtype=torch.float32, device=dev)
    C = nussinov_cuda.cluster_size(8, 352)
    ms = cuda_ms(lambda: nussinov_cuda.floor_probe(buf, 351, C), 10)
    print(f"kernel nussinov floor: 351 cluster barriers + L2 round trips, C={C}: {ms:.4f} ms")
    return ms


def kernel_times(dev):
    """K1, K2 and the posterior kernel, K3 and K4 at the main path's
    shapes; a kernel's row holds its last shape."""
    from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda, pairhmm, pairhmm_cuda

    rng = np.random.default_rng(0)
    tab = pairhmm.tables(dev)
    rows = {}
    for label, fa_name in (("L<=96", "RF00005_0.fa"), ("L<=320", "RF00017_4.fa")):
        args = pairhmm_inputs(read_fasta(fa_name), dev)
        lens = (args[1], args[3])
        fm, fcap = pairhmm_cuda.forward(*args, tab)
        bm, bcap = pairhmm_cuda.backward(*args, tab)
        floor_ms = pairhmm_floor(args, dev)
        shape = f"B={args[0].shape[0]} {label}"
        for name, kfn, pfn, replaces in (
            ("pairhmm_forward", lambda: pairhmm_cuda.forward(*args, tab),
             lambda: pairhmm.forward_plain(*args, tab), "dafs_tpu/ops/pairhmm_pallas.py:124"),
            ("pairhmm_backward", lambda: pairhmm_cuda.backward(*args, tab),
             lambda: pairhmm.backward_plain(*args, tab), "dafs_tpu/ops/pairhmm_pallas.py:236"),
            ("pairhmm_posterior", lambda: pairhmm_cuda.posterior(fm, fcap, bm, bcap, *lens, tab),
             lambda: pairhmm.posterior(fm, fcap, bm, bcap, *lens, tab),
             "dafs_tpu/ops/pairhmm_pallas.py:484"),
        ):
            k, p = [], []
            ms, plain_ms = cuda_ms(kfn, 20, k), cuda_ms(pfn, 1, p)
            rows[name] = row(name, "dafs_tpu_torch/csrc/pairhmm.cu", replaces, shape, ms,
                             plain_ms, pairhmm_bound(args, name),
                             floor_ms=None if name == "pairhmm_posterior" else floor_ms,
                             launched_by="pairhmm_cuda.forward_backward_posterior",
                             max_abs_err=held(f"{name} {shape}", k[0], p[0]))
        path_ms = cuda_ms(lambda: pairhmm.forward_backward_posterior(*args, tab), 20)
        print(f"kernel pairhmm codes to posteriors {shape}: {path_ms:.4f} ms (K1 beside K2, "
              f"then the posterior kernel)")

    # the padded lengths of the main path: RF00005's merges, RF00017's
    # merges, and RF00017's final structure (383 columns)
    for L in (96, 352, 384):
        sm, lens = nussinov_inputs(rng, 8, L, dev)
        k, p = [], []
        rows["nussinov"] = row("nussinov", "dafs_tpu_torch/csrc/nussinov.cu",
                               "dafs_tpu/ops/nussinov_pallas.py:76", f"B=8 L={L}",
                               cuda_ms(lambda: nussinov_cuda.decode(sm, lens), 10, k),
                               cuda_ms(lambda: nussinov.decode_plain(sm, lens), 1, p),
                               nussinov_bound(lens, L), cluster=nussinov_cuda.cluster_size(8, L),
                               max_abs_err=held(f"nussinov B=8 L={L}", k[0], p[0]))
    rows["nussinov"]["floor_ms"] = nussinov_floor(dev)
    # square merges, and RF00017's last merge: 337 against 317 columns
    for L1, L2 in ((96, 96), (320, 320), (352, 320)):
        args = nw_inputs(rng, 4, L1, L2, dev)
        k, p = [], []
        rows["nw"] = row("nw", "dafs_tpu_torch/csrc/nw.cu", "dafs_tpu/ops/nw_pallas.py:37",
                         f"B=4 {L1}x{L2}", cuda_ms(lambda: nw_cuda.decode(*args), 10, k),
                         cuda_ms(lambda: nw.decode_plain(*args), 1, p), nw_bound(args),
                         max_abs_err=held(f"nw B=4 {L1}x{L2}", k[0], p[0]))
    return rows


# ----------------------------------------------------------------- length --
# Past the main path kernels' old limits (imax 1024 rows for K1/K2, padded
# L 1024 for K3, 1023 columns or a block's shared memory for K4) the
# wrappers choose the long variants, up to the ceiling of 4096.

LONG_KERNELS = {
    "pairhmm_forward_long": ("dafs_tpu_torch/csrc/pairhmm.cu", "dafs_tpu/ops/pairhmm_pallas.py:124"),
    "pairhmm_backward_long": ("dafs_tpu_torch/csrc/pairhmm.cu",
                              "dafs_tpu/ops/pairhmm_pallas.py:236"),
    "nussinov_long": ("dafs_tpu_torch/csrc/nussinov.cu", "dafs_tpu/ops/nussinov_pallas.py:76"),
    "nw_long": ("dafs_tpu_torch/csrc/nw.cu", "dafs_tpu/ops/nw_pallas.py:37"),
}


def length_times(dev):
    """The long variants (their rows just past the old limits, at 1056;
    2048 printed), then each kernel once at the ceiling of 4096."""
    from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda, pairhmm, pairhmm_cuda

    rng = np.random.default_rng(6)
    tab = pairhmm.tables(dev)
    rows = {}
    for imax in (1056, 2048):
        L = imax - 1
        args = random_pairs(rng, [L, L - 37], [L - 11, L], L, L, dev)
        for name, kfn, pfn in (
            ("pairhmm_forward_long", lambda: pairhmm_cuda.forward(*args, tab),
             lambda: pairhmm.forward_plain(*args, tab)),
            ("pairhmm_backward_long", lambda: pairhmm_cuda.backward(*args, tab),
             lambda: pairhmm.backward_plain(*args, tab)),
        ):
            k, p = [], []
            ms = cuda_ms(kfn, 3, k)
            if imax == 1056:
                rows[name] = row(name, *LONG_KERNELS[name], f"B=2 imax={imax}", ms,
                                 once_ms(pfn, p), pairhmm_bound(args, name.replace("_long", "")),
                                 max_abs_err=held(f"{name} imax={imax}", k[0], p[0]))
            else:
                print(f"length {name} B=2 imax={imax}: {ms:.4f} ms", flush=True)
        ms = cuda_ms(lambda: pairhmm.forward_backward_posterior(*args, tab), 3)
        print(f"length pairhmm codes to posteriors B=2 imax={imax}: {ms:.4f} ms", flush=True)
    for L in (1056, 2048):
        for B in (1, 2):
            sm, lens = nussinov_inputs(rng, B, L, dev)
            k, p = [], []
            ms = cuda_ms(lambda: nussinov_cuda.decode(sm, lens), 1, k)
            if (L, B) == (1056, 2):
                rows["nussinov_long"] = row(
                    "nussinov_long", *LONG_KERNELS["nussinov_long"], f"B={B} L={L}", ms,
                    once_ms(lambda: nussinov.decode_plain(sm, lens), p), nussinov_bound(lens, L),
                    max_abs_err=held(f"nussinov_long B={B} L={L}", k[0], p[0]))
            else:
                print(f"length nussinov_long B={B} L={L}: {ms:.4f} ms", flush=True)
    for L1, L2 in ((1056, 1056), (800, 992), (2048, 2048)):
        args = nw_inputs(rng, 2, L1, L2, dev)
        k, p = [], []
        ms = cuda_ms(lambda: nw_cuda.decode(*args), 3, k)
        if L1 == 1056:
            rows["nw_long"] = row("nw_long", *LONG_KERNELS["nw_long"], f"B=2 {L1}x{L2}", ms,
                                  once_ms(lambda: nw.decode_plain(*args), p), nw_bound(args),
                                  max_abs_err=held(f"nw_long B=2 {L1}x{L2}", k[0], p[0]))
        else:
            print(f"length nw_long B=2 {L1}x{L2}: {ms:.4f} ms", flush=True)
    C = 4096
    args = random_pairs(rng, [C - 1, C - 300], [C - 1, C - 77], C - 1, C - 1, dev)
    sm, lens = nussinov_inputs(rng, 2, C, dev)
    nw_args = nw_inputs(rng, 2, C, C, dev)
    print(f"ceiling B=2 at {C}, one call each: pair-HMM codes to posteriors "
          f"{once_ms(lambda: pairhmm.forward_backward_posterior(*args, tab)):.4f} ms, "
          f"nussinov_long {once_ms(lambda: nussinov_cuda.decode(sm, lens)):.4f} ms, "
          f"nw_long {once_ms(lambda: nw_cuda.decode(*nw_args)):.4f} ms", flush=True)
    return rows


# -------------------------------------------------------------- consensus --
# The RNAalifold consensus's CUDA kernels (`csrc/alifold.cu`): inside and
# outside one cooperative launch a call each (a grid barrier between the
# n - 1 diagonals), exterior one launch.

ALIFOLD = {
    "alifold_inside": "dafs_tpu/ops/alifold_kernel.py:938",
    "alifold_exterior": "dafs_tpu/ops/alifold_kernel.py:957",
    "alifold_outside": "dafs_tpu/ops/alifold_kernel.py:1214",
}


def alifold_work(x, NS, bcut, tabs):
    """{kernel: (float operations, bytes)} of one consensus call on these
    inputs.  Operations: multiplies, adds and divides (compares and selects
    not counted) of the (outer pair, inner pair) combinations the stencil
    joins, both pair-allowed (the kernels skip the rest), by the cell's
    category (csrc/alifold.cu: 42 a sequence with the B group, 22 the whole
    A group, 12 or 6 the cut A group; 3 more a combination inside, 4
    outside), plus the multiloop sums, the exterior chains and the
    accumulator updates.  Bytes: what the function needs, read once and
    written once, on the same cells: the per-sequence channels (4 floats
    a side) and pair codes of the pair-allowed cells that are an outer or
    an inner pair of such a combination (the codes at one byte, the width
    their values 0..174 need; the B group's codes on its corner only); the
    per-cell factors and qb of the pair-allowed cells; qm, qm1 and bs_seg
    over the triangle; the pair mask a byte a cell; the letters and gap
    counts of the sequences (1 and 2 bytes); the loop tables `tabs`
    floats.  The B group's special tables are left out: a lower bound needs
    only the entries the data selects, and those are among the operations'
    table reads."""
    from dafs_tpu_torch.ops import alifold_cuda

    P = np.asarray(x["allow_pair"], bool)
    Lp, n = P.shape[0], x["n"]
    combos = 0.0
    seq_ops = 0.0
    inner, outer = np.zeros_like(P), np.zeros_like(P)
    inner_b, outer_b = np.zeros_like(P), np.zeros_like(P)
    for u, v in alifold_cuda.stencil_cells():
        # hit[a, b]: outer pair (a, b + 1 + v), inner pair (a + 1 + u, b)
        hit = P[: Lp - 1 - u, 1 + v :] & P[1 + u :, : Lp - 1 - v]
        c = float(hit.sum())
        full, uside = v < bcut, u < bcut
        combos += c
        seq_ops += c * (42 if full and uside else 22 if full else 12 if uside else 6)
        inner[1 + u :, : Lp - 1 - v] |= hit
        outer[: Lp - 1 - u, 1 + v :] |= hit
        if full and uside:
            inner_b[1 + u :, : Lp - 1 - v] |= hit
            outer_b[: Lp - 1 - u, 1 + v :] |= hit
    cells = n * (n + 1) / 2.0
    pi, pj = np.nonzero(P)
    pairs = float(len(pi))
    ml_in = 2.0 * float((pj - pi).sum()) + 3.0 * (cells + n * (n - 1) * (n + 1) / 6.0)
    ml_out = 5.0 * float((n - pj).sum())
    accum = 4.0 * n ** 3 / 6.0
    chan = 4 * 4 * NS                       # 4 float channels a sequence
    seqs = NS * (n + 2) * (1 + 1 + 2)       # S5, S3 letters, a2s gap counts
    common = seqs + 1 * cells + 4 * tabs    # and the pair mask, the loop tables
    n_in, n_out = float(inner.sum()), float(outer.sum())
    n_in_b, n_out_b = float(inner_b.sum()), float(outer_b.sum())
    # inside: channels of the outer and the inner pairs; the B group's codes
    # (3 outer, 1 inner); hp, psc, mlclose, mlstem read and qb written a
    # pair; bs_seg read, qm and qm1 written a cell; the gate a column
    inside_b = (chan * (n_out + n_in) + NS * (3 * n_out_b + n_in_b) + (4 * 4 + 4) * pairs
                + (4 + 2 * 4) * cells + 4 * n + common)
    # outside: the same channels and codes (3 inner, 1 outer); qb, ext,
    # mlstem, mlclose, psc read and pout written a pair; qm and bs_seg a
    # cell; q1 and qn a column, and Q
    outside_b = (chan * (n_out + n_in) + NS * (3 * n_in_b + n_out_b) + (5 * 4 + 4) * pairs
                 + 2 * 4 * cells + 2 * 4 * n + 4 + common)
    return {
        "alifold_inside": (NS * seq_ops + 3 * combos + ml_in + 10 * cells, inside_b),
        "alifold_exterior": (2 * 3.0 * pairs + 2 * 3.0 * n,
                             2 * 4 * pairs + 4 * n + 2 * 4 * n + 4),
        "alifold_outside": (NS * seq_ops + 4 * combos + ml_out + accum + 15 * pairs, outside_b),
    }


def consensus_rows(dev, label, seqs, bl):
    """The consensus kernels at one call, at the scale its ladder settles
    on: each kernel's CUDA-event ms beside the plain step's, its outputs
    held to the plain step's (`held`), the bound on these inputs, and the
    floors: the n - 1 grid barriers of one cooperative
    launch (`barrier_probe`), and a launch a diagonal (as many empty
    launches).  Returns {kernel: row}."""
    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    x = alifold._inputs(seqs, bl, None)
    n, NS = x["n"], x["S"].shape[0]
    BCUT = alifold._bcut(x["S"], n)
    args = alifold.device_args(x, dev)
    sc = alifold.partition(args, n, x["bsn0"], alifold.SC0, BCUT, alifold_cuda.call_loops())[2]
    shape = f"{label} (NS, n, Lp) = ({NS}, {n}, {x['L'] + 2}) BCUT {BCUT}"
    p = ak.prepare(*args, n, sc, x["bsn0"])
    i, e, o = [], [], []
    plain_ms = {"alifold_inside": once_ms(lambda: ak.inside(p, n, BCUT=BCUT), i)}
    qb_mat, qm, _, QBL = i[0]
    plain_ms["alifold_exterior"] = once_ms(lambda: ak.exterior(p, n, qb_mat), e)
    q1, qn, Q = e[0]
    plain_ms["alifold_outside"] = once_ms(
        lambda: ak.outside(p, n, QBL, qm, q1, qn, Q, BCUT=BCUT), o)
    pk = alifold_cuda.pack(p, n, BCUT)
    la = alifold_cuda.launch_args(pk)
    grids = (alifold_cuda.grid(pk, la), alifold_cuda.grid(pk, la, outside_scan=True))
    print(f"consensus {label}: {int(pk['tensors']['pairs'].numel())} pair-allowed cells of "
          f"{n * (n - 1) // 2} over {n - 1} diagonals; grids (CTAs of 256 threads) inside "
          f"{grids[0]}, outside {grids[1]}", flush=True)
    # (run, diagonals, its outputs, the plain step's, their tolerance kinds)
    # in launch order: each reads what the one before wrote
    t = pk["tensors"]
    runs = {"alifold_inside": (lambda: alifold_cuda.inside(pk, la), n - 1,
                               lambda: (t["qbl"],), (QBL[0],), ("qb",)),
            "alifold_exterior": (lambda: alifold_cuda.exterior(pk, la), None,
                                 lambda: (t["q1"], t["qn"], t["q"].reshape(())), (q1, qn, Q),
                                 ("q1", "qn", "Q")),
            "alifold_outside": (lambda: alifold_cuda.outside(pk, la), n - 1,
                                lambda: (t["pout"],), (o[0],), ("pout",))}
    work = alifold_work(x, NS, BCUT, ak.SW * ak.SW + 2 * ak.SW + 4)
    reps = 5 if n < 200 else 3
    rows = {}
    for name, (run, steps, got, want, kinds) in runs.items():
        ms = cuda_ms(run, reps)
        err = held(f"{name} {shape}", got(), want, kinds)
        launch_floor_ms = cuda_ms(lambda: alifold_cuda.floor_probe(dev, steps or 1), reps)
        floor_ms = (cuda_ms(lambda: alifold_cuda.barrier_probe(pk, la, steps), reps)
                    if steps else launch_floor_ms)
        rows[name] = row(name, "dafs_tpu_torch/csrc/alifold.cu", ALIFOLD[name], shape, ms,
                         plain_ms[name], bound(*work[name]), floor_ms=floor_ms,
                         launch_floor_ms=launch_floor_ms, diagonals=steps,
                         launched_by="alifold_cuda.inside_outside", max_abs_err=err)
    total = cuda_ms(lambda: alifold_cuda.inside_outside(p, n, BCUT=BCUT), reps)
    barriers = cuda_ms(lambda: alifold_cuda.barrier_probe(pk, la, 2 * (n - 1)), reps)
    floor = cuda_ms(lambda: alifold_cuda.floor_probe(dev, 2 * (n - 1) + 1), reps)
    print(f"consensus {label}: the three kernels {total:.4f} ms a call (pack and launches), "
          f"plain {sum(plain_ms.values()):.1f} ms; floor ({2 * (n - 1)} grid barriers) "
          f"{barriers:.4f} ms; a launch a diagonal ({2 * (n - 1) + 1} empty launches) "
          f"{floor:.4f} ms", flush=True)
    return rows


def consensus_times(dev):
    """The consensus kernels at the final call (the largest) of RF00005's,
    RF00017's and family-50's default runs: the output's rows; each row at
    family-50's, every family's numbers under "by_case"."""
    from dafs_tpu_torch import align_and_fold

    return by_case([(label, consensus_rows(dev, label, align_and_fold(fa, device=dev).rows, True))
                    for label, fa in (("RF00005 final", read_fasta("RF00005_0.fa")),
                                      ("RF00017 final", read_fasta("RF00017_4.fa")),
                                      ("family-50 final", family50()))], "family-50 final")


# ------------------------------------------------------------------- fold --
# The McCaskill fold's CUDA kernels (`csrc/mccaskill.cu`): inside and outside
# one cooperative launch an attempt each (a grid barrier between the
# diagonals), exterior one launch.

FOLD = {
    "mccaskill_inside": "dafs_tpu/ops/mccaskill_kernel.py:308",
    "mccaskill_exterior": "dafs_tpu/ops/mccaskill_kernel.py:336",
    "mccaskill_outside": "dafs_tpu/ops/mccaskill_kernel.py:494",
}
# -Xptxas -v of each kernel source: {source: {kernel: (registers, smem bytes,
# spill bytes)}}, filled by `ptxas_report`
PTXAS: dict = {}


def ptxas_start():
    """Starts nvcc -Xptxas -v on the fold's, the consensus's and the DD
    step's sources (the library's flags), in the background; `ptxas_report`
    reads it."""
    from dafs_tpu_torch.ops import cuda_lib

    out = os.path.join(cuda_lib.BUILD_DIR, "ptxas")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for src in ("mccaskill.cu", "alifold.cu", "dd_step.cu"):
        procs[src] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib._COMPILE_FLAGS, "-Xptxas", "-v", "-I", cuda_lib.CSRC_DIR,
             "-c", "-o", os.path.join(out, src + ".o"), os.path.join(cuda_lib.CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def ptxas_report(procs):
    """Fills PTXAS from `ptxas_start`'s compiles and prints each kernel's
    registers, shared memory and spills."""
    for src, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v {src} failed:\n{text[-3000:]}")
        table, fn = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                table.setdefault(fn, {})["spill"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and fn:
                table.setdefault(fn, {}).update(regs=int(m.group(1)), smem=int(m.group(2) or 0))
        PTXAS[src] = {}
        for fn, v in table.items():
            short = next((k for k in ("inside_kernel", "exterior_kernel", "outside_kernel",
                                      "barrier_kernel", "empty_kernel") if k in fn), fn)
            PTXAS[src][short] = v
        print(f"-Xptxas -v {src}: " + "; ".join(
            f"{k} {v.get('regs')} registers, {v.get('smem')} bytes smem, {v.get('spill', 0)} "
            f"bytes spilled" for k, v in sorted(PTXAS[src].items())), flush=True)


def fold_work(prep):
    """{kernel: (float operations, bytes)} of one ladder attempt of a
    bucket on these inputs.  Operations: multiplies, adds and divides
    (compares, selects and the gates, 1 here, not counted) of the stencil
    terms whose outer and inner pairs are both pair-allowed (2 each: the
    slot constant times the partner's factor, the add; the seven special
    slots 4), the multiloop rows (2 a term inside, 4 outside), the qm rows
    (3 a term, every cell), a pair cell's own work (about 20), the
    exterior chains (2 a pair-allowed cell, 3 a column) and the
    accumulator updates (4 a term).  Bytes: what each kernel needs, read
    once and written once: inside the cell factors of the pair-allowed
    cells (12 floats, the stem factor among them: a cell that cannot pair
    has qb 0 and needs none) and their qb written, bs_seg and the code byte
    of every cell, and qm, qm1 written; exterior qb ext of the pair-allowed cells
    read and q1, qn written; outside the cell factors and qb of the
    pair-allowed cells, qm and bs_seg of every cell, q1, qn read, pout
    written."""
    t = prep["tensors"]
    P = ((t["code"] >> 6) > 0).cpu().numpy()
    n = t["nlen"].cpu().numpy().astype(np.float64)
    B, Lp, _ = P.shape
    combos = 0.0
    for u in range(31):
        for v in range(31 - u):
            hit = P[:, : Lp - 1 - u, 1 + v :] & P[:, 1 + u :, : Lp - 1 - v]
            combos += float(hit.sum()) * (4 if (u, v) in ((0, 0), (0, 1), (1, 0), (1, 1), (1, 2),
                                                           (2, 1), (2, 2)) else 2)
    bb, pi, pj = np.nonzero(P)
    pairs = float(len(pi))
    span = (pj - pi).astype(np.float64)
    cells = float((n * (n - 1) / 2).sum())
    qm_terms = float((n * (n - 1) * (n + 1) / 6).sum())
    ml_out = float((n[bb] - pj).sum())
    accum = float(span.sum())
    cols = float(n.sum())
    inside = (combos + 2 * float((span - 2).clip(min=0).sum()) + 3 * qm_terms + 20 * pairs,
              (12 * 4 + 4) * pairs + (4 + 1 + 8) * cells)
    exterior = (2 * 2 * pairs + 2 * 3 * cols, 4 * pairs + 2 * 4 * cols + 4 * B)
    outside = (combos + 4 * ml_out + 4 * accum + 20 * pairs,
               (11 * 4 + 4 + 4) * pairs + 8 * cells + 2 * 4 * cols)
    return {"mccaskill_inside": inside, "mccaskill_exterior": exterior,
            "mccaskill_outside": outside}


def fold_rows(label, dev, seqs, cons=None, bl=True, stable=False, reps=5):
    """The fold kernels at the settled ladder attempt of `seqs` (from
    exp(-0.6), or where `stable` from a scale with Q near 1): each kernel's
    CUDA-event ms beside the plain step's, its outputs held to the plain
    step's (`held`), the bound on these inputs, the floor (the grid
    barriers of one launch; one empty launch for the exterior) and its
    registers.  Returns {kernel: row}."""
    import torch

    from dafs_tpu_torch.ops import alifold_cuda, mccaskill_cuda
    from dafs_tpu_torch.ops import mccaskill_kernel as MK

    sc0 = fold_stable_scale(seqs, dev, bl) if stable else None
    _, trace, last = traced_fold(seqs, dev, bl, cons, sc0, plain=False)
    prep, sc = last["prep"], last["sc"]
    ev = {k: torch.cuda.Event(enable_timing=True) for k in ("start", "inside", "exterior", "end")}
    torch.cuda.synchronize()
    ev["start"].record()
    pout, Q, parts = MK.mccaskill_fast(*last["args"], sc, last["codes"], last["tabs"],
                                       stage=lambda k: ev[k].record(), parts=True)
    ev["end"].record()
    torch.cuda.synchronize()
    plain_ms = {"mccaskill_inside": ev["start"].elapsed_time(ev["inside"]),
                "mccaskill_exterior": ev["inside"].elapsed_time(ev["exterior"]),
                "mccaskill_outside": ev["exterior"].elapsed_time(ev["end"])}
    pk = mccaskill_cuda.pack(prep, sc)
    la = mccaskill_cuda.launch_args(pk)
    maxn = prep["ints"]["maxn"]
    shape = f"{label} (B, Lp, maxn) = ({prep['ints']['nb']}, {prep['ints']['lp']}, {maxn})"
    grids = (mccaskill_cuda.grid(pk, la), mccaskill_cuda.grid(pk, la, outside_scan=True))
    print(f"fold {shape}: {len(trace)} ladder attempt(s); {int(pk['tensors']['pairs'].numel())} "
          f"pair-allowed cells over {maxn - 1} diagonals; grids (CTAs of 256 threads, a warp a "
          f"cell) inside {grids[0]}, outside {grids[1]}", flush=True)
    work = fold_work(prep)
    rows = {}
    t = pk["tensors"]
    for name, run, steps, got, want, kinds in (
        ("mccaskill_inside", lambda: mccaskill_cuda.inside(pk, la), maxn - 1,
         lambda: (card_checks.diag_to_rows(t["qbl"]),), (parts["qb"],), ("qb",)),
        ("mccaskill_exterior", lambda: mccaskill_cuda.exterior(pk, la), None,
         lambda: (t["q1"], t["qn"], t["q"]), (parts["q1"], parts["qn"], Q), ("q1", "qn", "Q")),
        ("mccaskill_outside", lambda: mccaskill_cuda.outside(pk, la), maxn - 1,
         lambda: (t["pout"],), (pout,), ("pout",)),
    ):
        ms = cuda_ms(run, reps)
        err = held(f"{name} {shape}", got(), want, kinds)
        floor_ms = (cuda_ms(lambda: mccaskill_cuda.barrier_probe(pk, la, steps), reps) if steps
                    else cuda_ms(lambda: alifold_cuda.floor_probe(dev, 1), reps))
        ptx = PTXAS.get("mccaskill.cu", {}).get(name.replace("mccaskill_", "") + "_kernel", {})
        rows[name] = row(name, "dafs_tpu_torch/csrc/mccaskill.cu", FOLD[name], shape, ms,
                         plain_ms[name], bound(*work[name]), floor_ms=floor_ms, diagonals=steps,
                         registers=ptx.get("regs"), smem_bytes=ptx.get("smem"),
                         launched_by="mccaskill.fold_attempt", max_abs_err=err)
    total = cuda_ms(lambda: mccaskill_cuda.mccaskill(prep, sc), reps)
    barriers = cuda_ms(lambda: mccaskill_cuda.barrier_probe(pk, la, 2 * (maxn - 1)), reps)
    print(f"fold {label}: the three kernels {total:.4f} ms an attempt (pack and launches), the "
          f"plain version {sum(plain_ms.values()):.1f} ms; floor ({2 * (maxn - 1)} grid "
          f"barriers) {barriers:.4f} ms", flush=True)
    return rows


def fold_times(dev):
    """The fold kernels at the main path's buckets and past them; each row
    at RF00017's fold, every case's numbers under "by_case"."""
    r5 = [f.seq for f in read_fasta("RF00005_0.fa")]
    rows17 = read_snapshot("rf00017_default_tpu.txt")[3]
    tiled = lambda n: [(r.replace("-", "") * (n // 290 + 1))[:n] for r in rows17[:2]]  # noqa: E731
    con_seqs, cons = refold_constraints("rf00005_default_tpu.txt")
    cases = [
        ("RF00005's fold", dict(seqs=r5)),
        ("RF00017's fold", dict(seqs=[f.seq for f in read_fasta("RF00017_4.fa")], reps=3)),
        ("family-50's fold", dict(seqs=[f.seq for f in family50()])),
        ("a single sequence", dict(seqs=r5[:1])),
        ("path (b)'s constrained re-fold", dict(seqs=con_seqs, cons=cons)),
        ("bl=False (path (a)'s consensus parameters)", dict(seqs=r5, bl=False)),
        ("n 1056", dict(seqs=tiled(1056), stable=True, reps=2)),
    ]
    return by_case([(label, fold_rows(label, dev, **kw)) for label, kw in cases],
                   "RF00017's fold")


# ---------------------------------------------------------------- dd step --
# The DD loop's multiplier step (`csrc/dd_step.cu`): three kernels and one
# `torch.sum` a body in place of the plain step's ~270 ATen launches.


def dd_step_bytes(pr, rule):
    """The bytes one body's step must move at this batch (every merge
    running): each multiplier cell's p, candidate mask and q read and q and
    score written, the optimiser planes read and written, the candidates
    (four int64 and the valid byte) read, the decodes read, x, y, z and the
    per-merge values written."""
    B, P1, P2 = pr["p_z"].shape
    U = pr["cbp"].shape[1]
    P = max(P1, P2)
    planes = {"subgradient": 0, "adagrad": 1, "adam": 2}[rule]
    cells = B * (P1 * P1 + P2 * P2 + P1 * P2)
    return (cells * (4 + 1 + 4 + 4 + 4 + 8 * planes) + B * U * 33
            + 4 * (2 * B * P + B * P1 + 3 * B) + 4 * B * (2 * P1 + P2) + 40 * B)


def dd_step_rows(label, problems, kw, dev, reps=50):
    """The step kernels at one layer's batch, every merge running: each
    kernel's device ms, the whole step's ms as the loop launches it and its
    device ms, the plain step's ms, the bound and the floor (one empty
    launch), after one step each way from the same state held bit-equal;
    returns {kernel: row}."""
    import ctypes

    import torch

    from dafs_tpu_torch import dd
    from dafs_tpu_torch.ops import alifold_cuda, cuda_lib, dd_step_cuda, nussinov, nw

    rule = kw.get("update_rule", "subgradient")
    pr, st = dd_state(problems, kw, rule)
    _, pl = dd_state(problems, kw, rule, plain=True)
    s_xy, xy = nussinov.decode(st.sm_xy, st.lens_xy)
    s_z, z_new = nw.decode(st.sm_z, pr["env_first"], pr["env_last"], pr["l1"], pr["l2"])
    done0 = st.done.clone()
    saved = dict(vars(pl))
    # one body's step each way from the same state: bit-equal states
    st.kernels(s_xy, xy, s_z, z_new)
    dd._step_plain(pl, s_xy, xy, s_z, z_new)
    torch.cuda.synchronize()
    bad = card_checks.dd_states_equal(st, pl)
    err = max_abs_err(*([getattr(s, n) for n in card_checks.DD_STATE] + list(s.opt)
                        for s in (st, pl)))
    if bad:
        raise AssertionError(f"dd step {label} ({rule}): the kernels' state differs from the "
                             f"plain step's in {bad} (max_abs_err {err!r})")

    def step():
        st.done.copy_(done0)
        st.kernels(s_xy, xy, s_z, z_new)

    def plain():
        vars(pl).update(saved)
        dd._step_plain(pl, s_xy, xy, s_z, z_new)

    ms = cuda_ms(step, reps)
    dev_ms, host_ms, spin_ms = queued_ms(step, reps)
    plain_ms = cuda_ms(plain, max(reps // 10, 3))
    floor_ms = cuda_ms(lambda: alifold_cuda.floor_probe(dev, 1), reps)
    a, p = ctypes.byref(st.kernels.args), cuda_lib.ptr
    s_sum = torch.sum(st.kernels.scratch["sw"], dim=1)

    def scalars():
        st.done.copy_(done0)
        dd_step_cuda.SCALARS(a, p(s_xy), p(xy), p(s_z), p(s_sum), p(z_new))

    parts = {
        "dd_candidates": lambda: dd_step_cuda.CANDIDATES(a),
        "dd_update": lambda: dd_step_cuda.UPDATE(a, p(xy), p(z_new)),
        "dd_scalars": scalars,
    }
    nbytes = dd_step_bytes(pr, rule)
    B, P1, P2 = pr["p_z"].shape
    shape = f"{label} (B {B}, P1 {P1}, P2 {P2}, U {pr['cbp'].shape[1]}, {rule})"
    print(f"dd step {shape}: {ms:.4f} ms a body as the loop launches it (with a copy of done "
          f"that keeps every merge running), {dev_ms:.4f} ms on the device (queued behind a "
          f"{spin_ms:.1f} ms spin in {host_ms:.1f} ms of host); plain step {plain_ms:.4f} ms",
          flush=True)
    return {name: row(name, "dafs_tpu_torch/csrc/dd_step.cu",
                      "none (XLA fused dafs_tpu/dd.py::_dd_core's body)", shape,
                      queued_ms(fn, reps)[0], plain_ms,
                      (nbytes / HBM_BYTES_PER_S * 1e3, "bytes", "bytes"), step_ms=ms,
                      step_device_ms=dev_ms, floor_ms=floor_ms, launched_by="dd._step",
                      max_abs_err=err)
            for name, fn in parts.items()}


def dd_step_times(dev):
    """The step kernels at RF00005's merge layers and family-50's first and
    last (captured from default runs); each row at the last, every layer's
    numbers under "by_case"."""
    cases = [(f"RF00005 layer {i}", lay) for i, lay in
             enumerate(dd_layers(read_fasta("RF00005_0.fa"), dev))]
    fam = dd_layers(family50(), dev)
    cases += [("family-50 first layer", fam[0]), ("family-50 last layer", fam[-1])]
    return by_case([(label, dd_step_rows(label, problems, kw, dev))
                    for label, (problems, kw) in cases], cases[-1][0])


# --------------------------------------------------------------- pair-CRF --
# The CONTRAlign pair-CRF's kernels (csrc/paircrf.cu).  Operations a cell:
# forward 12 log-adds and 26 adds and multiplies, backward 12 log-adds, 5
# maxima and 30 adds and multiplies, posterior five Fast_Exps and 5
# operations each, the clamp's two.

CRF_FORWARD_OPS = 12 * LOG_ADD_OPS + 26
CRF_BACKWARD_OPS = 12 * LOG_ADD_OPS + 35
CRF_POSTERIOR_OPS = 5 * (EXP_OPS + 5) + 2


def paircrf_bound(args, kernel):
    """Operations of the cells within the true lengths ((l1 + 1) x (l2 + 1)
    a pass, l1 x l2 the posterior, and Z's four log-adds a pair); bytes: the
    codes and lengths, and each kernel's own output within the lengths (F's
    five states, Bm's M), the posterior reading those cells and writing its
    whole padded plane."""
    c1, n1, c2, n2 = (a.cpu().numpy() for a in args)
    n1, n2 = n1.astype(np.int64), n2.astype(np.int64)
    B, imax = c1.shape
    W = c2.shape[1]
    codes = 4 * (c1.size + c2.size + 2 * B)
    if kernel == "paircrf_posterior":
        cells = float((n1 * n2).sum())
        return bound(cells * CRF_POSTERIOR_OPS + B * 4 * LOG_ADD_OPS,
                     codes + 24 * cells + 4 * B * (imax - 1) * (W - 1))
    cells = float(((n1 + 1) * (n2 + 1)).sum())
    if kernel == "paircrf_forward":
        return bound(cells * CRF_FORWARD_OPS, codes + 20 * cells)
    return bound(cells * CRF_BACKWARD_OPS, codes + 4 * cells)


def paircrf_shapes(dev):
    """(label, inputs): RF00005's 45 pairs (L 96) and contra-trna's largest
    batch, the 105 pairs of its 15-sequence family (mutated RF00005
    members, L 96; portbench/traffic/trna11.json)."""
    from portbench import traffic

    pool = traffic.Families(traffic.load_mix("trna11"), 0).pool
    (fam,) = [[s for _, s in f] for f in pool if len(f) == 15]
    out = []
    for label, ss in (("RF00005", [f.seq for f in read_fasta("RF00005_0.fa")]),
                      ("contra-trna 15", fam)):
        pairs = [(i, j) for i in range(len(ss)) for j in range(i + 1, len(ss))]
        out.append((label, paircrf_inputs([ss[i] for i, _ in pairs],
                                          [ss[j] for _, j in pairs], dev)))
    return out


def paircrf_times(dev):
    """The pair-CRF kernels at RF00005's bucket and at contra-trna's largest
    batch: each kernel's CUDA-event ms and the codes-to-posteriors path's
    beside the plain version's (one call: it has no separate passes), the
    posteriors held bit-equal to the plain version's, each
    kernel's bound, and the chain floor (`paircrf_cuda.floor_probe`: as
    many diagonals as the longest pair has, the backward M chain and the
    hand-over alone, at the passes' warps).  Each row at the last shape,
    both under "by_case"."""
    import torch

    from dafs_tpu_torch.ops import paircrf, paircrf_cuda

    cases = []
    for label, args in paircrf_shapes(dev):
        tab = paircrf.tables(dev)
        B, imax = args[0].shape
        k, p = [], []
        plain_ms = once_ms(lambda: paircrf.forward_backward_posterior_plain(*args, tab), p)
        path_ms = cuda_ms(lambda: paircrf.forward_backward_posterior(*args, tab), 20, k)
        err = held(f"paircrf {label} B={B}", k[0], p[0])
        steps = int((args[1] + args[3]).max()) + 1
        nw = paircrf_cuda.warps(imax)
        buf = torch.zeros(B * 32 * nw, dtype=torch.float32, device=dev)
        floor_ms = cuda_ms(lambda: paircrf_cuda.floor_probe(buf, steps, nw, B), 20)
        print(f"kernel paircrf {label} B={B} L={imax - 1}: codes to posteriors {path_ms:.4f} ms "
              f"(the two passes side by side, then the posterior kernel), the plain version "
              f"{plain_ms:.1f} ms; floor {floor_ms:.4f} ms ({steps} diagonals of four dependent "
              f"log-adds and the hand-over, {nw} warps)", flush=True)
        F = paircrf_cuda.forward(*args, tab)
        Bm = paircrf_cuda.backward(*args, tab)
        cases.append((label, {name: row(
            name, "dafs_tpu_torch/csrc/paircrf.cu", "dafs_tpu/ops/paircrf.py:58 (XLA scans)",
            f"B={B}, L={imax - 1}", cuda_ms(fn, 20), plain_ms, paircrf_bound(args, name),
            path_ms=path_ms, floor_ms=None if name == "paircrf_posterior" else floor_ms,
            launched_by="paircrf_cuda.forward_backward_posterior", max_abs_err=err)
            for name, fn in (
                ("paircrf_forward", lambda: paircrf_cuda.forward(*args, tab)),
                ("paircrf_backward", lambda: paircrf_cuda.backward(*args, tab)),
                ("paircrf_posterior", lambda: paircrf_cuda.posterior(F, Bm, *args, tab)))}))
    return by_case(cases, cases[-1][0])


# CONTRAfold's inside-outside (ops/contrafold.py), plain PyTorch replayed as
# one CUDA graph a bucket.  Work within the true lengths: each cell (i, j)
# of span d sums its single-branch loops, (m + 1)(m + 2) / 2 of them with
# m = min(30, d - 2), in the inside and again in the outside, each a score
# add and a log-add; its multiloop split, d - 1 terms, once inside and twice
# in the outside's adjoints; F5 and its outside j terms at j.


def contrafold_bound(lens, L):
    ops = 0.0
    for n in lens:
        for d in range(1, n):
            m = min(30, d - 2)
            single = (m + 1) * (m + 2) // 2 if m >= 0 else 0
            ops += (n - d) * (2 * single * (LOG_ADD_OPS + 1) + 3 * (d - 1) * (LOG_ADD_OPS + 1))
        ops += 2 * (n * (n + 1) // 2) * (LOG_ADD_OPS + 3)
    A = L + 2
    return bound(ops, len(lens) * (4 * A + A * A + A + 8 + 4 * A * A))


def contrafold_times(dev):
    """One CONTRAfold bucket at RF00005's (10, 96) and at contra-trna's
    largest, its 15-sequence family (L 96): the graph's replay (CUDA
    events), the bucket through `batch_bp_posteriors` (host clock: the
    uploads, the replay and the read-back) and the eager `inside_outside`
    on the unpadded batch, the plain version, whose posteriors the
    replay's must equal (`held`).  Each row at the last shape, both under
    "by_case"."""
    import torch

    from dafs_tpu_torch.ops import contrafold
    from portbench import traffic

    pool = traffic.Families(traffic.load_mix("trna11"), 0).pool
    (fam,) = [[s for _, s in f] for f in pool if len(f) == 15]
    card = torch.device("cuda", torch.cuda.current_device())
    tab = contrafold.tables(card)
    cases = []
    for label, seqs in (("RF00005", [f.seq for f in read_fasta("RF00005_0.fa")]),
                        ("contra-trna 15", fam)):
        B, L = len(seqs), -(-max(map(len, seqs)) // 32) * 32
        t = time.perf_counter()
        contrafold.batch_bp_posteriors(seqs, 0.0, card)
        first_s = time.perf_counter() - t
        rows = contrafold._graph_rows(B, L)
        graph = contrafold._GRAPHS[card, rows, L]
        arrays = contrafold._bucket_arrays(seqs, [None] * B, L, B)
        eager = []
        plain_ms = cuda_ms(lambda: contrafold.inside_outside(
            *(torch.from_numpy(a).to(card) for a in arrays), tab), 2, eager)
        ms = cuda_ms(graph.graph.replay, 20)
        host = []
        for _ in range(10):
            t = time.perf_counter()
            contrafold.batch_bp_posteriors(seqs, 0.0, card)
            host.append(1e3 * (time.perf_counter() - t))
        err = held(f"contrafold {label} B={B}", graph.post[:B], eager[0])
        path_ms = float(np.median(host))
        print(f"contrafold {label} (B, Bp, L) = ({B}, {rows}, {L}): first call (capture and "
              f"replay) {first_s:.3f} s; replay {ms:.3f} ms on the card; a bucket "
              f"{path_ms:.3f} ms (uploads, replay, read-back); eager {plain_ms:.1f} ms", flush=True)
        cases.append((label, {"contrafold_graph": row(
            "contrafold_graph", "dafs_tpu_torch/ops/contrafold.py (a CUDA graph a bucket)",
            "none: XLA of dafs_tpu/ops/contrafold.py", f"B={B}, Bp={rows}, L={L}", ms, plain_ms,
            contrafold_bound([len(s) for s in seqs], L), path_ms=path_ms,
            capture_s=first_s, launched_by="contrafold.batch_bp_posteriors", max_abs_err=err)}))
    return by_case(cases, cases[-1][0])


def run_launches(dev):
    """Every row of `card_checks.RUNS` on the card, each held to its row
    (`card_checks.hold_run`); prints each run's seconds and the kernels it
    launched.  Returns {run id: {kernel: launches}} (the "multiproc" row,
    whose ranks count their own, left out)."""
    import pathlib

    tmp = pathlib.Path(ROOT, "build", "chip_smoke")
    tmp.mkdir(parents=True, exist_ok=True)
    out = {}
    for run in card_checks.RUNS:
        t = time.perf_counter()
        counts = card_checks.hold_run(run, dev, tmp)
        print(f"run {run.id}: {time.perf_counter() - t:.1f}s, launches "
              f"{ {k: v for k, v in (counts or {}).items() if v} }", flush=True)
        if counts is not None:
            out[run.id] = counts
    return out


GROUPS = {"kernels": kernel_times, "length": length_times, "consensus": consensus_times,
          "fold": fold_times, "dd_step": dd_step_times, "paircrf": paircrf_times,
          "contrafold": contrafold_times, "runs": run_launches}


def main() -> int:
    import torch

    groups = sys.argv[1:] or list(GROUPS)
    if set(groups) - set(GROUPS):
        raise SystemExit(f"chip_smoke: groups are {', '.join(GROUPS)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from dafs_tpu_torch.ops import cuda_lib

    smi = smi_line()
    print(smi)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ptxas = ptxas_start()
    cuda_lib.library()
    print(f"built and loaded {cuda_lib.build()} in {time.perf_counter() - t0:.1f}s")
    ptxas_report(ptxas)
    rows, seconds, by_run = {}, {}, {}
    for group in groups:
        t = time.perf_counter()
        out = GROUPS[group](dev)
        (by_run if group == "runs" else rows).update(out)
        seconds[group] = round(time.perf_counter() - t, 1)
        print(f"group {group}: {seconds[group]}s", flush=True)
    for name, r in rows.items() if by_run else ():
        if name not in by_run["default RF00005"]:  # no kernel of the library
            continue
        r["launches"] = by_run["default RF00005"][name] + by_run["default RF00017"][name]
        r["launches_by_path"] = {run: counts[name] for run, counts in by_run.items()}
    print(f"group seconds: {seconds}")
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "groups": groups, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
