#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dafs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's `nvidia-smi` name and power limit; fails without CUDA.
2. Builds the CUDA kernels from `dafs_tpu_torch/csrc/` (nvcc, sm_90a).
3. Kernel phase: runs each kernel (K1 pair-HMM forward, K2 backward, the
   pair-HMM posterior kernel, K3 Nussinov, K4 NW) on the card at the shapes
   of the main path and holds it against its plain PyTorch version on the
   same inputs; every one must be bit-equal.  Times both with CUDA events,
   and works out each kernel's roofline bound from the inputs' true
   lengths.  For the pair-HMM also: the dependency floor (the chain of
   diagonals alone), the time from base codes to posteriors beside the
   eager posterior step it replaced, and stress batches (ragged lengths
   around a warp's 32 rows, rectangular shapes, one pair, 1225 pairs), each
   bit-equal.  Then K3 and K4 on tie-heavy scores (quarter steps, -0.0) and
   on the DD loop's batch shapes with ragged lengths down to 0, each
   bit-equal to the plain version, and K3's dependency floor (cluster
   barriers and L2 round trips alone).
4. Slice phase: resets the launch counts, runs DAFS's default path,
   `align_and_fold(..., device="cuda")` with the RNAalifold consensus mixed
   into every merge and the final structure, on RF00005 (10 tRNAs) and
   RF00017 (10 SRP RNAs) from `tests/data/`, and checks that every kernel
   was launched, that every output row is its input sequence with gaps, and
   that each guide-tree topology equals the TPU snapshot's
   (`tests/snapshots/*_default_tpu.txt` line 1).  RF00005's `SS_cons` and
   gapped rows must equal its snapshot's; RF00017's merges mostly stop at
   the 600-iteration cap without converging, so for it the agreeing columns
   are counted and printed.  Prints the phase split and the consensus calls
   (count, seconds, slowest call, retry-ladder attempts), the largest
   tree-score difference, and the RF00017 similarity matrix against the
   recorded one.
5. Prints the kernel table as one JSON line, then `{"ok": true, ...}` last.

Any failure raises and exits non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
SNAP = os.path.join(ROOT, "tests", "snapshots")
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call of `fn` over `reps` calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def read_fasta(name):
    from dafs_tpu_torch.fasta import load_fasta

    return load_fasta(os.path.join(DATA, name))


# ---------------------------------------------------------------- kernels --


def pairhmm_inputs(fa, dev):
    import torch

    from dafs_tpu_torch.ops import pairhmm

    seqs = [f.seq for f in fa]
    pairs = [(i, j) for i in range(len(seqs)) for j in range(i + 1, len(seqs))]
    lmax = -(-max(len(s) for s in seqs) // 32) * 32
    c1, n1 = pairhmm.encode_batch([seqs[i] for i, _ in pairs], lmax)
    c2, n2 = pairhmm.encode_batch([seqs[j] for _, j in pairs], lmax)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


def ragged_lens(rng, B, L, short):
    """True lengths near L, the last `short` of them 0, 1, 2, ... (a DD
    batch holds problems of many lengths)."""
    lens = rng.integers(L - 40, L + 1, size=B).astype(np.int32)
    lens[B - short:] = np.arange(short) % 6
    return lens


def quarter_steps(rng, shape):
    """Scores in quarter steps, zeros half of them -0.0: exact sums, so
    every max and every tie-break is exercised."""
    sm = (rng.integers(-4, 5, size=shape) / 4).astype(np.float32)
    neg0 = (sm == 0) & (rng.random(shape) < 0.5)
    sm[neg0] = np.float32(-0.0)
    return sm


def nussinov_ties(rng, B, L, dev, short=0):
    import torch

    lens = ragged_lens(rng, B, L, short)
    return (torch.from_numpy(quarter_steps(rng, (B, L, L))).to(dev),
            torch.from_numpy(lens).to(dev))


def nussinov_inputs(rng, B, L, dev, short=0):
    import torch

    lens = ragged_lens(rng, B, L, short)
    sm = np.full((B, L, L), np.float32(-0.8), np.float32)
    for b in range(B):
        n = int(lens[b])
        if n < 4:
            continue
        p = np.zeros((n, n), np.float32)
        for _ in range(int(rng.integers(n, 3 * n))):
            i = int(rng.integers(0, n - 3))
            j = int(rng.integers(i + 3, n))
            p[i, j] = rng.random()
        q = (rng.random((n, n)) * 0.2).astype(np.float32)
        sm[b, :n, :n] = np.float32(np.float32(4.0) * (p - np.float32(0.2)) - q)
    return torch.from_numpy(sm).to(dev), torch.from_numpy(lens).to(dev)


def nw_inputs(rng, B, L1, L2, dev, short=0, ties=False):
    """Banded NW problems; `ties`: quarter-step posteriors with -0.0 among
    the scores, so M/X/Y ties are frequent."""
    import torch

    from dafs_tpu_torch.ops import nw

    th = np.float32(0.25 if ties else 0.01)
    sm = np.full((B, L1, L2), -th, np.float32)
    envf = np.zeros((B, L1 + 1), np.int32)
    envl = np.full((B, L1 + 1), L2, np.int32)
    l1 = ragged_lens(rng, B, L1, short)
    l2 = rng.integers(L2 - 40, L2 + 1, size=B).astype(np.int32)
    for b in range(B):
        n1, n2 = int(l1[b]), int(l2[b])
        if ties:
            p = np.abs(quarter_steps(rng, (n1, n2))) * (rng.random((n1, n2)) < 0.3)
            q = np.abs(quarter_steps(rng, (n1, n2))) / 2
            s = np.float32(p - th + q)
            s[rng.random((n1, n2)) < 0.05] = np.float32(-0.0)
        else:
            p = np.zeros((n1, n2), np.float32)
            for i in range(n1):
                j = int(np.clip(round(i * n2 / n1 + rng.integers(-3, 4)), 0, n2 - 1))
                p[i, j] = 0.3 + 0.7 * rng.random()
                if rng.random() < 0.3:
                    p[i, int(rng.integers(0, n2))] += 0.2
            q = (rng.random((n1, n2)) * 0.1).astype(np.float32)
            s = np.float32(p - th + q)
        env = nw.envelope(p, th)
        sm[b, :n1, :n2] = s
        envf[b, : n1 + 1] = env[:, 0]
        envl[b, : n1 + 1] = env[:, 1]
    return [torch.from_numpy(a).to(dev) for a in (sm, envf, envl, l1, l2)]


def max_abs(a, b) -> float:
    import torch

    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


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


def same(got, want):
    """(bit-equal, max_abs_err) of two tuples of tensors."""
    import torch

    torch.cuda.synchronize()
    return (all(torch.equal(g, w) for g, w in zip(got, want)),
            max(max_abs(g, w) for g, w in zip(got, want)))


def stress_decoders(rng, dev):
    """K3 and K4 on tie-heavy scores (quarter steps, -0.0) and on the DD
    loop's batch shapes with ragged true lengths down to 0; each case must
    be bit-equal to the plain version.  Also K3 at shapes whose tables or
    traceback codes do not fit in shared memory."""
    from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda

    cases = [("nussinov ties", B, L, nussinov_ties(rng, B, L, dev, short))
             for B, L, short in ((8, 352, 2), (10, 320, 6), (1, 96, 0))]
    cases += [("nussinov DD batch", B, L, nussinov_inputs(rng, B, L, dev, short))
              for B in (2, 4, 10) for L, short in ((320, B // 2), (352, min(B, 6)))]
    # the other layouts (csrc/nussinov.cu): tables on chip with the codes in
    # global memory, everything in global memory, and global tables with
    # the codes on chip (four CTAs a problem)
    cases += [(label, B, L, nussinov_inputs(rng, B, L, dev))
              for label, B, L in (("on-chip tables, global codes", 1, 512),
                                  ("global tables and codes", 1, 700),
                                  ("global tables, on-chip codes", 40, 352))]
    for label, B, L, args in cases:
        exact, err = same(nussinov_cuda.decode(*args), nussinov.decode_plain(*args))
        print(f"kernel nussinov {label} B={B} L={L} lens={args[1].tolist()}: "
              f"bit-equal={exact} C={nussinov_cuda.cluster_size(B, L)}")
        if not exact:
            raise AssertionError(f"nussinov {label} B={B} L={L}: kernel differs "
                                 f"from plain version (max_abs_err {err})")
    cases = [("nw ties", B, L1, L2, nw_inputs(rng, B, L1, L2, dev, short, ties=True))
             for B, L1, L2, short in ((4, 320, 320, 1), (5, 352, 320, 2), (1, 96, 96, 0))]
    cases += [("nw DD batch", B, L1, L2, nw_inputs(rng, B, L1, L2, dev, short))
              for B in (1, 2, 5) for L1, L2, short in ((320, 320, B // 2), (352, 320, 0))]
    for label, B, L1, L2, args in cases:
        exact, err = same(nw_cuda.decode(*args), nw.decode_plain(*args))
        print(f"kernel nw {label} B={B} {L1}x{L2} l1={args[3].tolist()}: "
              f"bit-equal={exact}")
        if not exact:
            raise AssertionError(f"nw {label} B={B} {L1}x{L2}: kernel differs "
                                 f"from plain version (max_abs_err {err})")


def random_pairs(rng, lens1, lens2, l1max, l2max, dev):
    """Pair-HMM inputs for random sequences of these true lengths."""
    import torch

    from dafs_tpu_torch.ops import pairhmm

    def seqs(lens):
        return ["".join(rng.choice(list("ACGU"), size=int(n))) for n in lens]
    c1, n1 = pairhmm.encode_batch(seqs(lens1), l1max)
    c2, n2 = pairhmm.encode_batch(seqs(lens2), l2max)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


def pairhmm_plain(args, tab):
    """(fm, fcap), (bm, bcap), posteriors of the plain versions."""
    from dafs_tpu_torch.ops import pairhmm

    f = pairhmm.forward_plain(*args, tab)
    b = pairhmm.backward_plain(*args, tab)
    return f, b, pairhmm.posterior(*f, *b, args[1], args[3], tab)


def stress_pairhmm(rng, dev, tab):
    """K1, K2 and the posterior path on batches at the edges of the design:
    true lengths around a warp's 32 rows (and 0) in one batch, more rows
    than columns and the reverse, one pair, and the 1225 pairs of a
    50-sequence family (several waves of blocks).  Each must be bit-equal
    to the plain versions."""
    from dafs_tpu_torch.ops import pairhmm, pairhmm_cuda

    n = rng.integers
    cases = [
        ("ragged", random_pairs(rng, [1, 2, 31, 32, 33, 64, 0, 64], [64, 33, 32, 31, 2, 1, 9, 64], 64, 64, dev)),
        ("96x320", random_pairs(rng, n(60, 97, 6), n(200, 321, 6), 96, 320, dev)),
        ("320x96", random_pairs(rng, n(200, 321, 6), n(60, 97, 6), 320, 96, dev)),
        ("one pair", random_pairs(rng, [77], [91], 96, 96, dev)),
        ("50-sequence family", random_pairs(rng, n(60, 97, 1225), n(60, 97, 1225), 96, 96, dev)),
    ]
    for label, args in cases:
        B = args[0].shape[0]
        want_f, want_b, want_p = pairhmm_plain(args, tab)
        exact = [same(pairhmm_cuda.forward(*args, tab), want_f)[0],
                 same(pairhmm_cuda.backward(*args, tab), want_b)[0],
                 same((pairhmm_cuda.forward_backward_posterior(*args, tab),), (want_p,))[0]]
        print(f"kernel pairhmm {label} B={B} {args[0].shape[1] - 1}x{args[2].shape[1] - 1}: "
              f"forward, backward, posteriors bit-equal={exact}")
        if not all(exact):
            raise AssertionError(f"pairhmm {label}: kernels differ from the plain versions")
        if B >= 1000:
            ms = [cuda_ms(lambda: pairhmm_cuda.forward(*args, tab), 5),
                  cuda_ms(lambda: pairhmm_cuda.backward(*args, tab), 5),
                  cuda_ms(lambda: pairhmm.forward_backward_posterior(*args, tab), 5)]
            print(f"kernel pairhmm B={B} L<=96: forward {ms[0]:.4f} ms, backward {ms[1]:.4f} ms, "
                  f"codes to posteriors {ms[2]:.4f} ms")


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


def floor_probe(dev):
    """Times K3's dependency floor at (8, 352): 351 cluster barriers, each
    after one dependent L2 round trip, on a cluster of the size the
    wrapper picks there."""
    import torch

    from dafs_tpu_torch.ops import nussinov_cuda

    buf = torch.zeros(64 * 32, dtype=torch.float32, device=dev)
    C = nussinov_cuda.cluster_size(8, 352)
    ms = cuda_ms(lambda: nussinov_cuda.floor_probe(buf, 351, C), 10)
    print(f"kernel nussinov floor: 351 cluster barriers + L2 round trips, "
          f"C={C}: {ms:.4f} ms")
    return ms


def kernel_phase(dev):
    """Returns {kernel name: row of the JSON table}; raises on a mismatch.
    A kernel's row holds its last timed shape."""
    from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda
    from dafs_tpu_torch.ops import pairhmm, pairhmm_cuda

    rng = np.random.default_rng(0)
    tab = pairhmm.tables(dev)
    rows = {}

    def record(name, source, replaces, err, ms, plain_ms, bnd):
        bound_ms, bound_by, bound_kind = bnd
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=0, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, bound_kind=bound_kind,
                          library_ms=None)
        print(f"  bound {bound_ms:.6f} ms ({bound_by}); kernel at "
              f"{bound_ms / ms:.2e} of it")

    for label, fa_name in (("L<=96", "RF00005_0.fa"), ("L<=320", "RF00017_4.fa")):
        args = pairhmm_inputs(read_fasta(fa_name), dev)
        lens = (args[1], args[3])
        fm, fcap = pairhmm_cuda.forward(*args, tab)
        bm, bcap = pairhmm_cuda.backward(*args, tab)
        floor_ms = pairhmm_floor(args, dev)
        for name, kfn, pfn, replaces in (
            ("pairhmm_forward", lambda: pairhmm_cuda.forward(*args, tab),
             lambda: pairhmm.forward_plain(*args, tab), "dafs_tpu/ops/pairhmm_pallas.py:124"),
            ("pairhmm_backward", lambda: pairhmm_cuda.backward(*args, tab),
             lambda: pairhmm.backward_plain(*args, tab), "dafs_tpu/ops/pairhmm_pallas.py:236"),
            ("pairhmm_posterior", lambda: (pairhmm_cuda.posterior(fm, fcap, bm, bcap, *lens, tab),),
             lambda: (pairhmm.posterior(fm, fcap, bm, bcap, *lens, tab),),
             "dafs_tpu/ops/pairhmm_pallas.py:484"),
        ):
            exact, err = same(kfn(), pfn())
            ms = cuda_ms(kfn, 20)
            plain_ms = cuda_ms(pfn, 1)
            print(f"kernel {name} B={args[0].shape[0]} {label}: bit-equal={exact} "
                  f"max_abs_err={err!r} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not exact:
                raise AssertionError(f"{name} {label}: kernel differs from the plain "
                                     f"version (max_abs_err {err})")
            record(name, "dafs_tpu_torch/csrc/pairhmm.cu", replaces, err, ms,
                   plain_ms, pairhmm_bound(args, name))
            # what the passes are judged against: the chain of diagonals alone
            rows[name]["floor_ms"] = None if name == "pairhmm_posterior" else floor_ms
            rows[name]["launched_by"] = "pairhmm_cuda.forward_backward_posterior"
            if floor_ms and name != "pairhmm_posterior":
                print(f"  dependency floor {floor_ms:.4f} ms; kernel at {ms / floor_ms:.2f} times it")
        # base codes to masked posteriors: the three kernels, against the
        # plain versions end to end and beside the eager posterior step
        want = pairhmm_plain(args, tab)[2]
        exact, err = same((pairhmm.forward_backward_posterior(*args, tab),), (want,))
        path_ms = cuda_ms(lambda: pairhmm.forward_backward_posterior(*args, tab), 20)
        eager_ms = cuda_ms(lambda: pairhmm.posterior(fm, fcap, bm, bcap, *lens, tab), 5)
        print(f"kernel pairhmm codes to posteriors B={args[0].shape[0]} {label}: "
              f"bit-equal={exact} {path_ms:.4f} ms (K1 beside K2, then the posterior "
              f"kernel); the eager posterior step alone {eager_ms:.4f} ms")
        if not exact:
            raise AssertionError(f"pairhmm posteriors {label}: kernels differ from the "
                                 f"plain versions (max_abs_err {err})")
    stress_pairhmm(rng, dev, tab)

    # the padded lengths of the main path: RF00005's merges, RF00017's
    # merges, and RF00017's final structure (383 columns)
    for L in (96, 352, 384):
        sm, lens = nussinov_inputs(rng, 8, L, dev)
        exact, err = same(nussinov_cuda.decode(sm, lens), nussinov.decode_plain(sm, lens))
        ms = cuda_ms(lambda: nussinov_cuda.decode(sm, lens), 10)
        plain_ms = cuda_ms(lambda: nussinov.decode_plain(sm, lens), 1)
        print(f"kernel nussinov B=8 L={L}: bit-equal={exact} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} C={nussinov_cuda.cluster_size(8, L)}")
        if not exact:
            raise AssertionError(f"nussinov L={L}: kernel differs from plain version")
        record("nussinov", "dafs_tpu_torch/csrc/nussinov.cu",
               "dafs_tpu/ops/nussinov_pallas.py:76", err, ms, plain_ms,
               nussinov_bound(lens, L))

    # square merges, and RF00017's last merge: 337 against 317 columns
    for L1, L2 in ((96, 96), (320, 320), (352, 320)):
        args = nw_inputs(rng, 4, L1, L2, dev)
        exact, err = same(nw_cuda.decode(*args), nw.decode_plain(*args))
        ms = cuda_ms(lambda: nw_cuda.decode(*args), 10)
        plain_ms = cuda_ms(lambda: nw.decode_plain(*args), 1)
        print(f"kernel nw B=4 L1={L1} L2={L2}: bit-equal={exact} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}")
        if not exact:
            raise AssertionError(f"nw {L1}x{L2}: kernel differs from plain version")
        record("nw", "dafs_tpu_torch/csrc/nw.cu", "dafs_tpu/ops/nw_pallas.py:37",
               err, ms, plain_ms, nw_bound(args))

    stress_decoders(rng, dev)
    floor_probe(dev)
    return rows


# ------------------------------------------------------------------ slice --


def kernels():
    from dafs_tpu_torch.ops import nussinov_cuda, nw_cuda, pairhmm_cuda

    return {
        "pairhmm_forward": pairhmm_cuda.FORWARD,
        "pairhmm_backward": pairhmm_cuda.BACKWARD,
        "pairhmm_posterior": pairhmm_cuda.POSTERIOR,
        "nussinov": nussinov_cuda.DECODE,
        "nw": nw_cuda.DECODE,
    }


def check_rows(res, fa):
    seqs = {f.name: f.seq for f in fa}
    if res.names != [f.name for f in fa]:
        raise AssertionError("output rows are not in input order")
    for n, r in zip(res.names, res.rows):
        if r.replace("-", "") != seqs[n] or len(r) != len(res.ss_cons):
            raise AssertionError(f"row {n} is not its input sequence with gaps")


def read_snapshot(name):
    """(tree, SS_cons, names, rows) of a recorded TPU output."""
    with open(os.path.join(SNAP, name)) as fh:
        lines = fh.read().splitlines()
    return lines[0].strip(), lines[2], [l[2:] for l in lines[3::2]], lines[4::2]


def consensus_summary(name, calls):
    ali = [c for c in calls if c["route"] == "alifold"]
    slow = max(calls, key=lambda c: c["seconds"])
    per_call = "; ".join(
        f"({c['ns']}, {c['n']}) {c['route']} {c['seconds'] * 1e3:.1f}ms"
        + (f" x{c['attempts']}" if c["attempts"] else "")
        for c in calls
    )
    print(f"{name} consensus: {len(calls)} calls ({len(ali)} alifold, "
          f"{len(calls) - len(ali)} single-sequence McCaskill), "
          f"{sum(c['seconds'] for c in calls):.3f}s in all; slowest "
          f"{slow['seconds']:.3f}s at (NS, n, padded L) = ({slow['ns']}, {slow['n']}, "
          f"{-(-slow['n'] // 32) * 32}); "
          f"retry-ladder attempts {sum(c['attempts'] for c in ali)} over "
          f"{len(ali)} alifold calls")
    print(f"{name} consensus calls (NS, n): {per_call}")


def columns_agreeing(a, b):
    return sum(x == y for x, y in zip(a, b)), max(len(a), len(b))


def slice_phase(dev):
    """Returns the launch count of every kernel over both runs."""
    import torch

    from dafs_tpu_torch import align_and_fold

    for k in kernels().values():
        k.launches = 0
    for fa_name, snap_name in (("RF00005_0.fa", "rf00005_default_tpu.txt"),
                               ("RF00017_4.fa", "rf00017_default_tpu.txt")):
        fa = read_fasta(fa_name)
        before = {name: k.launches for name, k in kernels().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = align_and_fold(fa, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
        print(f"slice {fa_name}: {wall:.3f}s wall; {phases}")
        consensus_summary(fa_name, res.consensus_calls)
        for name, k in kernels().items():
            if k.launches <= before[name]:
                raise AssertionError(f"{fa_name}: kernel {name} was not launched")
        check_rows(res, fa)
        snap, snap_ss, snap_names, snap_rows = read_snapshot(snap_name)
        if NUM.sub("#", res.tree) != NUM.sub("#", snap):
            raise AssertionError(f"{fa_name} tree topology differs:\n{res.tree}\n{snap}")
        digits = max(abs(float(a) - float(b)) for a, b in
                     zip(NUM.findall(res.tree), NUM.findall(snap)))
        print(f"{fa_name} tree topology equals the TPU snapshot; largest score "
              f"difference {digits!r}; SS_cons {res.ss_cons}")
        if res.names != snap_names:
            raise AssertionError(f"{fa_name}: names differ from the snapshot's")
        ss_ok, ss_all = columns_agreeing(res.ss_cons, snap_ss)
        row_ok = [columns_agreeing(r, w) for r, w in zip(res.rows, snap_rows)]
        print(f"{fa_name} against the TPU snapshot: SS_cons {ss_ok} of {ss_all} "
              f"columns agree (lengths {len(res.ss_cons)} and {len(snap_ss)}); rows "
              f"{sum(a for a, _ in row_ok)} of {sum(b for _, b in row_ok)} columns "
              f"agree, {sum(r == w for r, w in zip(res.rows, snap_rows))} of "
              f"{len(snap_rows)} rows identical")
        if fa_name.startswith("RF00005") and (res.ss_cons != snap_ss or res.rows != snap_rows):
            raise AssertionError(f"{fa_name}: SS_cons or rows differ from the TPU snapshot")
        if fa_name.startswith("RF00017"):
            sim = np.load(os.path.join(SNAP, "rf00017_replay.npz"))["sim"]
            print(f"RF00017 similarity: max |port - recorded| = "
                  f"{float(np.abs(res.similarity - sim).max())!r}")
    counts = {name: k.launches for name, k in kernels().items()}
    print(f"launch counts over the two runs: {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from dafs_tpu_torch.ops import cuda_lib

    smi = smi_line()
    print(smi)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"built and loaded {cuda_lib.build()} in {time.perf_counter() - t0:.1f}s")
    rows = kernel_phase(dev)
    counts = slice_phase(dev)
    for name, n in counts.items():
        rows[name]["launches"] = n
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
