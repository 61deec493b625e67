#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dafs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py dd_step [kernels length fold paircrf]   # those phases alone

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
   recorded one.  Records every consensus call's alignment.
4a. Consensus phase (after 4): family-50 (the 50-sequence family of the
   mesh phase) through the whole default path on two shards of one card,
   its consensus calls recorded; then the RNAalifold consensus kernels
   (`csrc/alifold.cu`: inside, exterior, outside) at RF00005's final call,
   RF00017's largest call and family-50's last (NS 50), each for bl True
   and False, a constrained call (the run's `SS_cons`), BCUT 8 and 31 and
   a start from a scale at which Q overflows, through the pf-scale ladder
   under the plain loops on the card and under the kernels: every attempt
   at the same scale with the same reading of Q and pout, and at the last
   pout within rtol 2e-4 / atol 1e-6 and Q within rtol 2e-4.  At each
   shape's first case, the call's host prep and the plain loops' device
   kernels (torch.profiler), then each kernel against its plain step (qb,
   q1, qn and Q within rtol 2e-4 and a millionth of their largest value;
   pout as above), two runs bit-equal, one launch, its CUDA-event ms
   beside the plain step's, its bound (operations and bytes of these
   inputs) and its floor: the n - 1 grid barriers of one cooperative
   launch (`barrier_probe`), and beside it the floor of a launch a diagonal (as
   many empty launches, one after another); the pair-allowed cell count
   and each scan's grid.
   In every run of the slice, consensus, paths, solvers, options and mesh
   phases the consensus kernels must have launched exactly as often as the
   run's alifold calls need (one inside, one exterior and one outside
   launch a ladder attempt).
5. Paths phase: the slice's other configurations through the same entry
   point, each with the launch counts set to 0 just before it and read just
   after: path (a), `align_model="CONTRAlign", fold_model="CONTRAfold"`
   (the consensus with Vienna's parameters), on RF00005 and RF00017, and
   path (b), `use_bp_update=True, use_bp_update1=True` (bp-update with the
   default models), on RF00005.  Path (a) must launch K3, K4 and the
   pair-CRF kernels (its CONTRAfold fold is plain PyTorch on the card, and
   no pair-HMM kernel runs), path (b) all five kernels and no pair-CRF
   kernel.  Checks every row and that `SS_cons` is balanced, and holds
   each tree topology to the
   `dafs_tpu` reference recorded on the CPU
   (`tests/snapshots/*_contrafold_contralign_cpu.txt`,
   `rf00005_bp_update_cpu.txt`), printing how many `SS_cons` and row
   columns agree with it; prints the wall, the phase split (for path (a)
   the fold phase is the plain CONTRAfold code, the align phase the
   pair-CRF kernels), the consensus calls and the launch counts.  Before
   the runs, holds the plain CONTRAfold code and the pair-CRF kernels on
   the card to their CPU runs on RF00005 inputs (1e-5 and 1e-6).
6. Length phase (between 3 and 4): each kernel's long variant, which the
   wrappers choose past the old limits, just past them and at 2048
   (K1/K2 and the posteriors at imax 1056 and 2048, B = 2; K3 at L 1056
   and 2048, B = 1 and 2; K4 at 1056 x 1056, 800 x 992 and 2048 x 2048),
   bit-equal to its plain version, with its time and bound; once at the
   ceiling of 4096, timed and checked well formed (finite posteriors, a
   nested structure, an increasing alignment); above it, the error must
   name the ceiling.  Then the consensus kernels past RF00017's widths
   (`consensus_lengths`): at n 1056, NS 2 and 10, against the plain loops
   on the card with the ladder and determinism checks of the consensus
   phase; at n 2048 (NS 10) well formed and bit-equal across two runs.
6a. Fold phase (after 6): the McCaskill fold's kernels (`csrc/mccaskill.cu`:
   inside, exterior, outside), through `mccaskill.batch_bp_posteriors_fast`'s
   pf-scale ladder under the plain version on the card and under the
   kernels, at RF00005's fold (B 10, L 96), RF00017's (10, 320),
   family-50's (50, 96), one sequence, path (b)'s constrained re-fold
   (RF00005's TPU `SS_cons` projected onto each row), bl=False, a start
   from a scale at which every Q overflows (RF00005) and the
   length phase's n 1056 (B 2, RF00017's rows repeated, from a scale with
   Q near 1): every attempt at the same scales with the same reading of
   each row, the posteriors within rtol 2e-4 / atol 1e-6, Q within rtol
   2e-4; then each kernel against the plain step (qb, q1, qn within rtol
   2e-4 and a millionth of their largest value, pout as above), two runs
   bit-equal, one launch, CUDA-event ms beside the plain step's, the bound
   on these inputs, the floor (`mccaskill_cuda.barrier_probe`: the grid
   barriers of one launch) and `-Xptxas -v`'s registers and shared
   memory (printed at the build, with the consensus's).  n 2048 (B 2) is
   checked well formed and bit-equal across two runs, and whether the
   ladder settles at n 1056 from its first scale is printed.  In every run of the
   slice, consensus, paths, solvers, options and mesh phases the fold
   kernels must have launched once each per ladder attempt of each bucket
   shard on the card (the calls of `mccaskill_cuda.mccaskill`, counted by
   `watch_fold`), and the plain McCaskill on no card tensor (`check_fold`).
6b. DD step phase (after 6a): the DD loop's multiplier step kernels
   (`csrc/dd_step.cu`: candidates, update, scalars) at the batches of
   RF00005's merge layers and family-50's first and last (captured from
   `align_and_fold` runs on the card): under each update rule, 40 loop
   bodies through the kernels and through the plain step (`dd._step_plain`,
   ATen on the card), every state array bit-equal after every body and the
   kernels' score matrices the plain ones; each layer's `solve_by_dd_batch`
   through both equal in (s, x, y, z, iterations, violations); then the
   step's CUDA-event ms as the loop launches it, its device ms (queued behind
   a spin of the card) and each kernel's, beside the plain step's ms, its
   bound (the bytes a body must move at 3.35 TB/s), the floor (one empty
   launch) and one launch a kernel a body.  The slice phase prints the step
   kernels' launches beside K3's.
6c. Pair-CRF phase (after 6b): the CONTRAlign pair-CRF's kernels
   (`csrc/paircrf.cu`: forward, backward, posterior) at RF00005's bucket
   (B 45, L 96) and at contra-trna's largest batch (B 105, L 96): the
   posteriors bit-equal to the plain version on the card, each kernel's
   CUDA-event ms and the codes-to-posteriors path's beside the plain
   version's, each kernel's bound and the chain floor
   (`paircrf_cuda.floor_probe`).
7. Solvers phase (last): the host merge solvers, counts set to 0 before
   each run: (c) `--ipknot` and (d) `-m 0` on RF00005 with the options the
   CLI builds, each tree topology held to `dafs_tpu`'s CPU output
   (`tests/snapshots/rf00005_{ipknot,ilp}_cpu.txt`), every row its input
   with gaps, every bracket level balanced, K4 launches equal to the host
   DD iterations under (c) and none under (d), and under (d) `SS_cons` and
   every row equal to the snapshot's; prints the agreeing columns, each
   host DD merge's iterations and violations at exit, scipy's version and
   the HiGHS binding, the wall and the phase split.  (e) `-v 2` on RF00005 with standard output captured: its
   output equals the `dd_host=True` run's, one dump per iteration.  (f)
   the RF00017 frozen replay (`tests/snapshots/rf00017_replay.npz`)
   through the port's host DD with K3 and K4: tree line, `SS_cons` and
   every row equal the frozen output.
8. Prints the kernel table as one JSON line (K1-K4, the long variants,
   the consensus's, the fold's, the DD step's and the pair-CRF's kernels),
   then `{"ok": true, ...}` last.  Every launch count in it was read after
   a run whose counts were set to 0 just before: `launches` from the default path's two runs (the
   slice phase, where the variants too are counted), `launches_by_path`
   from each run of the paths, solvers, options and mesh phases, and for the
   variants also `launches_length_phase`.
9. Options phase (after the solvers phase): `dafs_tpu`'s last single-card
   options on RF00005 through `align_and_fold` with the keywords the CLI
   builds, counts set to 0 before each run: (g) `-r 2` (each refinement's
   groups and s_new against s; the final score at least the score before
   refinement), (h) `-f 0.5` (before it, the four-way products on
   RF00005's own posteriors on the card against the CPU, 1e-6, with the
   entries that cross CUTOFF), (i) `--dd-update adagrad`, (j)
   `--dd-update adam` (each merge's DD iterations and violations at exit),
   (k) `--save-align-aux` / `--save-fold-aux` into `build/`, then a run
   from `--align-aux` / `--fold-aux` (the arrays read back bit-equal to the
   first run's, its tree, `SS_cons` and rows equal, no pair-HMM launch),
   (l) `-P tests/data/ml_ninio.par` (the fold posteriors change; reset to
   `{}` after, a default run then prints the slice phase's RF00005 bytes).
   Each run: every row its input with gaps, `SS_cons` balanced, the tree
   topology equal to `dafs_tpu`'s CPU output
   (`tests/snapshots/rf00005_{refine2,fourway,adagrad,adam,param_file}_cpu.txt`),
   and `SS_cons` and rows too where no merge stopped at the 600 cap.  Then
   `-f 0.5 -r 1` on RF00017, held to rows, balance and score.  Prints each
   run's wall, phase split, DD merges and launches.
10. Mesh phase (last): multi-device execution (`dafs_tpu_torch.parallel`),
   counts set to 0 before each run.  (m1) The 50-sequence family of
   `bench.py` (from RF00005): fold, all-pairs (K1, K2 and the posterior
   kernel on each shard), similarity, PCT bp, PCT mp and the guide tree on
   a mesh of two shards of one card, each stage bit-equal to the
   single-device run; prints each stage's seconds both ways, the launches
   and the peak bytes per device.  (m2) `dryrun_multichip(2)`: three
   configurations, each byte-equal to its single-device run.  (m3)
   RF00005's default path on two shards: tree topology, `SS_cons` and rows
   equal the TPU snapshot, the bytes the slice phase's.  (m4)
   `python -m dafs_tpu_torch.parallel.multiproc --nprocs 2`: two
   processes sharing the card under gloo, its three `bitwise_equal_*`
   flags true.  (m5) With two or more cards, m1, m3 and m4 again across
   all of them (m4 under NCCL, a card a rank); with one, a line that says
   it did not run and why.

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


def once_ms(fn):
    """Milliseconds of one call of `fn` (CUDA events), no warm-up."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


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
                          replaces=replaces, max_abs_err=err,
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


# ----------------------------------------------------------------- length --
# Past the main path kernels' old limits (imax 1024 rows for K1/K2, padded
# L 1024 for K3, 1023 columns or a block's shared memory for K4) the
# wrappers choose the long variants; up to the ceiling of 4096 no shape is
# refused.

LONG_KERNELS = {
    "pairhmm_forward_long": ("pairhmm_cuda", "FORWARD_LONG", "dafs_tpu_torch/csrc/pairhmm.cu",
                             "dafs_tpu/ops/pairhmm_pallas.py:124"),
    "pairhmm_backward_long": ("pairhmm_cuda", "BACKWARD_LONG", "dafs_tpu_torch/csrc/pairhmm.cu",
                              "dafs_tpu/ops/pairhmm_pallas.py:236"),
    "nussinov_long": ("nussinov_cuda", "DECODE_LONG", "dafs_tpu_torch/csrc/nussinov.cu",
                      "dafs_tpu/ops/nussinov_pallas.py:76"),
    "nw_long": ("nw_cuda", "DECODE_LONG", "dafs_tpu_torch/csrc/nw.cu",
                "dafs_tpu/ops/nw_pallas.py:37"),
}


def long_kernels():
    from dafs_tpu_torch.ops import nussinov_cuda, nw_cuda, pairhmm_cuda

    mods = {"pairhmm_cuda": pairhmm_cuda, "nussinov_cuda": nussinov_cuda, "nw_cuda": nw_cuda}
    return {name: getattr(mods[m], attr) for name, (m, attr, _, _) in LONG_KERNELS.items()}


def valid_structure(ss, l):
    """Whether ss (left ends only, -1 elsewhere) is a nested structure
    within the true length l."""
    ss = ss.tolist()
    stack, right = [], {}
    for i, j in enumerate(ss):
        if j >= 0 and (i >= l or not i < j < l or j in right):
            return False
        if j >= 0:
            right[j] = i
    for i in range(l):
        if ss[i] >= 0:
            stack.append(ss[i])
        elif i in right:
            if not stack or stack.pop() != i:
                return False
    return not stack and all(v < 0 for v in ss[l:])


def valid_alignment(al, l1, l2):
    """Whether al matches increasing columns within l2, gaps (-1) elsewhere."""
    m = al[:l1][al[:l1] >= 0]
    return (bool((m < l2).all()) and bool((np.diff(m) > 0).all())
            and bool((al[l1:] < 0).all()))


def length_phase(dev):
    """Each long variant just past its kernel's old limit and at 2048,
    bit-equal to its plain version; then once at the ceiling, well formed.
    Returns {variant name: row of the JSON table}, the launches of this
    phase in `launches_length_phase`."""
    import torch

    from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda, pairhmm, pairhmm_cuda

    rng = np.random.default_rng(6)
    tab = pairhmm.tables(dev)
    rows = {}
    for k in long_kernels().values():
        k.launches = 0

    def record(name, err, ms, plain_ms, bnd):
        _, _, source, replaces = LONG_KERNELS[name]
        bound_ms, bound_by, bound_kind = bnd
        rows[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bound_kind=bound_kind,
                          library_ms=None)
        print(f"  bound {bound_ms:.6f} ms ({bound_by}); kernel at {bound_ms / ms:.2e} of it",
              flush=True)

    for imax in (1056, 2048):
        L = imax - 1
        args = random_pairs(rng, [L, L - 37], [L - 11, L], L, L, dev)
        want_f, want_b, want_p = pairhmm_plain(args, tab)
        for name, kfn, want, pfn in (
            ("pairhmm_forward_long", lambda: pairhmm_cuda.forward(*args, tab), want_f,
             lambda: pairhmm.forward_plain(*args, tab)),
            ("pairhmm_backward_long", lambda: pairhmm_cuda.backward(*args, tab), want_b,
             lambda: pairhmm.backward_plain(*args, tab)),
        ):
            exact, err = same(kfn(), want)
            ms = cuda_ms(kfn, 3)
            plain_ms = once_ms(pfn) if imax == 1056 else None
            print(f"length {name} B=2 imax={imax}: bit-equal={exact} max_abs_err={err!r} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms}", flush=True)
            if not exact:
                raise AssertionError(f"{name} imax={imax}: differs from the plain version")
            if imax == 1056:
                base = name.replace("_long", "")
                record(name, err, ms, plain_ms, pairhmm_bound(args, base))
        exact, err = same((pairhmm.forward_backward_posterior(*args, tab),), (want_p,))
        ms = cuda_ms(lambda: pairhmm.forward_backward_posterior(*args, tab), 3)
        print(f"length pairhmm codes to posteriors B=2 imax={imax}: bit-equal={exact} "
              f"max_abs_err={err!r} {ms:.4f} ms", flush=True)
        if not exact:
            raise AssertionError(f"pairhmm posteriors imax={imax}: differ from the plain versions")

    for L in (1056, 2048):
        for B in (1, 2):
            sm, lens = nussinov_inputs(rng, B, L, dev)
            exact, err = same(nussinov_cuda.decode(sm, lens), nussinov.decode_plain(sm, lens))
            ms = cuda_ms(lambda: nussinov_cuda.decode(sm, lens), 1)
            plain_ms = once_ms(lambda: nussinov.decode_plain(sm, lens)) if L == 1056 else None
            print(f"length nussinov_long B={B} L={L} lens={lens.tolist()}: bit-equal={exact} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms} C={nussinov_cuda.cluster_size(B, L)}",
                  flush=True)
            if not exact:
                raise AssertionError(f"nussinov L={L} B={B}: differs from the plain version")
            if L == 1056 and B == 2:
                record("nussinov_long", err, ms, plain_ms, nussinov_bound(lens, L))

    for L1, L2 in ((1056, 1056), (800, 992), (2048, 2048)):
        args = nw_inputs(rng, 2, L1, L2, dev)
        if not nw_cuda.is_long(L1, L2):
            raise AssertionError(f"nw {L1}x{L2} does not go to the long variant")
        exact, err = same(nw_cuda.decode(*args), nw.decode_plain(*args))
        ms = cuda_ms(lambda: nw_cuda.decode(*args), 3)
        plain_ms = once_ms(lambda: nw.decode_plain(*args)) if L1 == 1056 else None
        print(f"length nw_long B=2 {L1}x{L2}: bit-equal={exact} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms}", flush=True)
        if not exact:
            raise AssertionError(f"nw {L1}x{L2}: differs from the plain version")
        if L1 == 1056:
            record("nw_long", err, ms, plain_ms, nw_bound(args))
    args = nw_inputs(rng, 2, 800, 992, dev, ties=True)
    exact, _ = same(nw_cuda.decode(*args), nw.decode_plain(*args))
    print(f"length nw_long ties B=2 800x992: bit-equal={exact}", flush=True)
    if not exact:
        raise AssertionError("nw 800x992 ties: differs from the plain version")

    # the ceiling, once each: times and well-formed outputs
    C = 4096
    args = random_pairs(rng, [C - 1, C - 300], [C - 1, C - 77], C - 1, C - 1, dev)
    ms = once_ms(lambda: pairhmm.forward_backward_posterior(*args, tab))
    post = pairhmm.forward_backward_posterior(*args, tab)
    ok = bool(torch.isfinite(post).all()) and float(post.min()) >= -1e-5 and float(post.max()) <= 1.0
    print(f"ceiling pairhmm codes to posteriors B=2 imax={C}: {ms:.4f} ms; finite in "
          f"[-1e-5, 1]: {ok}", flush=True)
    if not ok:
        raise AssertionError("pairhmm at the ceiling: posteriors not well formed")
    sm, lens = nussinov_inputs(rng, 2, C, dev)
    ms = once_ms(lambda: nussinov_cuda.decode(sm, lens))
    score, ss = nussinov_cuda.decode(sm, lens)
    ok = all(valid_structure(ss[b].cpu().numpy(), int(lens[b])) for b in range(2))
    ok = ok and bool(torch.isfinite(score).all())
    print(f"ceiling nussinov_long B=2 L={C}: {ms:.4f} ms; valid structures: {ok}; "
          f"pairs {[int((ss[b] >= 0).sum()) for b in range(2)]}", flush=True)
    if not ok:
        raise AssertionError("nussinov at the ceiling: not a valid structure")
    args = nw_inputs(rng, 2, C, C, dev)
    ms = once_ms(lambda: nw_cuda.decode(*args))
    score, al = nw_cuda.decode(*args)
    ok = all(valid_alignment(al[b].cpu().numpy(), int(args[3][b]), int(args[4][b]))
             for b in range(2)) and bool(torch.isfinite(score).all())
    print(f"ceiling nw_long B=2 {C}x{C}: {ms:.4f} ms; valid alignments: {ok}; matches "
          f"{[int((al[b] >= 0).sum()) for b in range(2)]}", flush=True)
    if not ok:
        raise AssertionError("nw at the ceiling: not a valid alignment")
    for label, fn in (
        ("pairhmm", lambda: pairhmm_cuda.forward(*random_pairs(rng, [5], [5], C, 64, dev), tab)),
        ("nussinov", lambda: nussinov_cuda.decode(torch.zeros((1, C + 32, C + 32), device=dev),
                                                  torch.ones(1, dtype=torch.int32, device=dev))),
        ("nw", lambda: nw_cuda.decode(*nw_inputs(rng, 1, 64, C + 32, dev))),
    ):
        try:
            fn()
        except ValueError as e:
            if str(C) not in str(e):
                raise AssertionError(f"{label} above the ceiling: the error does not name it: {e}")
            print(f"above the ceiling {label}: ValueError naming {C}")
        else:
            raise AssertionError(f"{label} above the ceiling ran")
    for name, k in long_kernels().items():
        rows[name]["launches_length_phase"] = k.launches
    t0 = time.perf_counter()
    consensus_lengths(dev)
    print(f"length phase: the consensus rows took {time.perf_counter() - t0:.1f}s", flush=True)
    return rows


# (NS, n, held to the plain loops) of `consensus_lengths`
LONG_CONSENSUS = ((2, 1056, True), (10, 1056, True), (10, 2048, False))


def stable_scale(args, n, bsn0, BCUT):
    """A per-column scale at which Q lies near 1, found with the kernels (Q
    scales as sc ** n).  Past n of about 520 one step of the pf-scale
    ladder (0.8 or 1.25 a column) moves Q by more than the ladder's window
    of 1e-25 to 1e25, so a long alignment starts from here."""
    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    sc = np.float32(alifold.SC0)
    for _ in range(40):
        _, Q = alifold_cuda.inside_outside(ak.prepare(*args, n, sc, bsn0), n, BCUT=BCUT)
        q = float(Q)
        if np.isfinite(q) and 1e-5 < q < 1e5:
            return sc
        if np.isfinite(q) and q > 1e-30:
            sc = np.float32(sc * (1.0 / q) ** (1.0 / n))
        else:
            sc = np.float32(sc * 10.0 ** ((-30.0 if not np.isfinite(q) else 30.0) / n))
    raise AssertionError(f"consensus n {n}: no scale with Q near 1")


def consensus_lengths(dev):
    """The consensus kernels past RF00017's widths, on RF00017's TPU rows
    repeated side by side and cut to n columns.  At n 1056 (NS 2 and 10):
    from a scale with Q near 1 (`stable_scale`), the ladder under the plain
    loops on the card and under the kernels (the same attempts and
    readings, pout within rtol 2e-4 / atol 1e-6, Q within rtol 2e-4); one
    attempt at a scale where Q overflows, read alike; two runs bit-equal.
    At n 2048 (NS 10) only well formed: Q finite, pout in [0, 1 + 2e-4]
    (the consensus's rtol; the consensus clips to [0, 1]), two runs
    bit-equal."""
    import torch

    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    rows17 = read_snapshot("rf00017_default_tpu.txt")[3]
    for NS, n, plain in LONG_CONSENSUS:
        t0 = time.perf_counter()
        seqs = [(r * (n // len(r) + 1))[:n] for r in rows17[:NS]]
        x = alifold._inputs(seqs, True, None)
        BCUT = alifold._bcut(x["S"], n)
        args = alifold.device_args(x, dev)
        bsn0 = x["bsn0"]
        sc = stable_scale(args, n, bsn0, BCUT)
        tr_k = []
        got = alifold.partition(args, n, bsn0, sc, BCUT, traced(alifold_cuda.call_loops(), tr_k))
        p = ak.prepare(*args, n, got[2], bsn0)
        first = [t.clone() for t in alifold_cuda.inside_outside(p, n, BCUT=BCUT)]
        exact = all(torch.equal(a, b)
                    for a, b in zip(first, alifold_cuda.inside_outside(p, n, BCUT=BCUT)))
        ms = cuda_ms(lambda: alifold_cuda.inside_outside(p, n, BCUT=BCUT), 2)
        npairs = int(alifold_cuda.pair_lists(p["APL"], n)[0].numel())
        head = (f"length consensus (NS, n) = ({NS}, {n}) BCUT {BCUT}, {npairs} pair-allowed "
                f"cells: kernels {ms:.4f} ms a call; ladder from sc {float(sc)!r}: "
                f"{len(tr_k)} attempt(s), Q {got[1]!r}; two runs bit-equal={exact}")
        if plain:
            tr_p = []
            t1 = time.perf_counter()
            want = alifold.partition(args, n, bsn0, sc, BCUT, traced(ak.inside_outside, tr_p))
            plain_s = time.perf_counter() - t1
            err = float(np.abs(got[0].astype(np.float64) - want[0]).max())
            ok = (consensus_agree(got[0], want[0], "pout") and consensus_agree(got[1], want[1], "Q")
                  and got[2:] == want[2:] and ladder_steps(tr_k) == ladder_steps(tr_p))
            sc_over = np.float32(got[2] * np.float32((1e39 / got[1]) ** (1.0 / n)))
            po = ak.prepare(*args, n, sc_over, bsn0)
            read = [(bool(torch.isfinite(Q)), bool(torch.isfinite(pout).all()))
                    for pout, Q in (alifold_cuda.inside_outside(po, n, BCUT=BCUT),
                                    ak.inside_outside(po, n, BCUT=BCUT))]
            ok = ok and read[0] == read[1] and not read[0][0]
            print(f"{head}; plain loops {plain_s:.1f} s, Q {want[1]!r}, pout max_abs_err "
                  f"{err!r}, within rtol 2e-4 (atol 1e-6 pout, 0 Q) with the same attempts: "
                  f"{ok}; at sc {float(sc_over)!r} (Q finite, pout finite) kernels "
                  f"{read[0]} plain {read[1]} ({time.perf_counter() - t0:.1f}s)", flush=True)
        else:
            pout, Q = first
            lo, hi = float(pout.min()), float(pout.max())
            ok = bool(torch.isfinite(Q)) and bool(torch.isfinite(pout).all()) and lo >= 0.0 \
                and hi <= 1.0 + 2e-4
            print(f"{head}; pout in [{lo!r}, {hi!r}]; well formed: {ok} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if not (ok and exact):
            raise AssertionError(f"consensus (NS, n) = ({NS}, {n}): not well formed, not "
                                 "bit-equal across runs or unlike the plain loops")


# ------------------------------------------------------------------ slice --


def kernels():
    from dafs_tpu_torch.ops import nussinov_cuda, nw_cuda, pairhmm_cuda

    return {
        "pairhmm_forward": pairhmm_cuda.FORWARD,
        "pairhmm_backward": pairhmm_cuda.BACKWARD,
        "pairhmm_posterior": pairhmm_cuda.POSTERIOR,
        "nussinov": nussinov_cuda.DECODE,
        "nw": nw_cuda.DECODE,
        **alifold_kernels(),
        **fold_kernels(),
        **dd_step_kernels(),
    }


def check_rows(res, fa):
    seqs = {f.name: f.seq for f in fa}
    if res.names != [f.name for f in fa]:
        raise AssertionError("output rows are not in input order")
    for n, r in zip(res.names, res.rows):
        if r.replace("-", "") != seqs[n] or len(r) != len(res.ss_cons):
            raise AssertionError(f"row {n} is not its input sequence with gaps")


def read_snapshot(name):
    """(tree, SS_cons, names, rows) of a recorded output."""
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
    """Returns the launch count of every kernel and variant over both runs;
    raises unless each main path kernel was launched in each."""
    import torch

    from dafs_tpu_torch import align_and_fold

    for k in all_kernels().values():
        k.launches = 0
    for fa_name, snap_name in (("RF00005_0.fa", "rf00005_default_tpu.txt"),
                               ("RF00017_4.fa", "rf00017_default_tpu.txt")):
        fa = read_fasta(fa_name)
        before = {name: k.launches for name, k in all_kernels().items()}
        watch_fold()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_consensus(CONSENSUS_CALLS.setdefault(fa_name, [])):
            res = align_and_fold(fa, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        SS_CONS[fa_name] = res.ss_cons
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
        print(f"slice {fa_name}: {wall:.3f}s wall; {phases}")
        consensus_summary(fa_name, res.consensus_calls)
        check_consensus(f"slice {fa_name}", res.consensus_calls,
                        {name: k.launches - before[name] for name, k in all_kernels().items()})
        for name, k in kernels().items():
            if k.launches <= before[name]:
                raise AssertionError(f"{fa_name}: kernel {name} was not launched")
        step = {name: k.launches - before[name] for name, k in dd_step_kernels().items()}
        print(f"slice {fa_name}: DD step kernels {step}, K3 "
              f"{kernels()['nussinov'].launches - before['nussinov']} (a body each, and the "
              f"final decode)")
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
        SLICE_OUTPUT[fa_name] = str(res)
        if fa_name.startswith("RF00017"):
            sim = np.load(os.path.join(SNAP, "rf00017_replay.npz"))["sim"]
            print(f"RF00017 similarity: max |port - recorded| = "
                  f"{float(np.abs(res.similarity - sim).max())!r}")
    counts = {name: k.launches for name, k in all_kernels().items()}
    print(f"launch counts over the two runs: {counts}")
    for name in kernels():
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return counts


# -------------------------------------------------------------- consensus --
# The RNAalifold consensus's CUDA kernels (`csrc/alifold.cu`): inside and
# outside one cooperative launch a call each (a grid barrier between the
# n - 1 diagonals), exterior one launch.  Each alifold call of a run
# launches each of the three once an attempt of its pf-scale ladder.

ALIFOLD = {
    "alifold_inside": ("INSIDE", "dafs_tpu/ops/alifold_kernel.py:938"),
    "alifold_exterior": ("EXTERIOR", "dafs_tpu/ops/alifold_kernel.py:957"),
    "alifold_outside": ("OUTSIDE", "dafs_tpu/ops/alifold_kernel.py:1214"),
}
# (family or run, its consensus calls as (seqs, constraint, bl)), recorded
# in the slice phase and family-50's run
CONSENSUS_CALLS: dict = {}
SS_CONS: dict = {}


def alifold_kernels():
    from dafs_tpu_torch.ops import alifold_cuda

    return {name: getattr(alifold_cuda, attr) for name, (attr, _) in ALIFOLD.items()}


def check_consensus(label, calls, counts):
    """The consensus kernels ran for the run's alifold calls, and only as
    often as those calls need: one inside, one exterior and one outside
    launch an attempt (the diagonals, n - 1 a scan, are grid barriers
    inside a launch)."""
    ali = [c for c in calls if c["route"] == "alifold"]
    attempts = sum(c["attempts"] for c in ali)
    want = {name: attempts for name in ALIFOLD}
    got = {name: counts[name] for name in ALIFOLD}
    steps = sum(c["attempts"] * (c["n"] - 1) for c in ali)
    print(f"{label}: consensus kernels {got} for {len(ali)} alifold calls "
          f"({attempts} ladder attempts; {steps} diagonals a scan, summed over them)", flush=True)
    if got != want:
        raise AssertionError(f"{label}: consensus launches {got}, the alifold calls need {want}")
    check_fold(label, counts)


class recorded_consensus:
    """Records (seqs, constraint, bl) of every consensus call while on."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        from dafs_tpu_torch.ops import alifold

        self.saved = fn = alifold.Alifold.consensus

        def rec(obj, seqs, device, constraint=None, bcut=None):
            self.store.append((list(seqs), constraint, obj.bl))
            return fn(obj, seqs, device, constraint, bcut)

        alifold.Alifold.consensus = rec
        return self.store

    def __exit__(self, *exc):
        from dafs_tpu_torch.ops import alifold

        alifold.Alifold.consensus = self.saved


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


def consensus_agree(got, want, kind):
    """The consensus tolerance, rtol 2e-4, with the atol each value takes:
    1e-6 for the pair probabilities pout (as between the plain version and
    `dafs_tpu`); none for Q; a millionth of the largest |want| for qb's
    plane and the exterior chains q1 and qn, whose scale is the ladder's."""
    import torch

    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double().to(got.device)
    atol = {"pout": 1e-6, "Q": 0.0}.get(kind)
    if atol is None:
        atol = 1e-6 * float(want.abs().max())
    return bool(torch.allclose(got, want, rtol=2e-4, atol=atol))


def traced(loops, trace):
    """`loops` recording each ladder attempt's scale, Q and whether pout is
    finite."""
    import torch

    def run(p, n, BCUT):
        pout, Q = loops(p, n, BCUT=BCUT)
        trace.append((float(p["sc_t"]), float(Q), bool(torch.isfinite(pout).all())))
        return pout, Q

    return run


def ladder_steps(trace):
    """Each attempt's scale and what the ladder read from it: Q not finite,
    at or above 1e25, at or below 1e-25, pout not finite."""
    return [(sc, not np.isfinite(q), q >= 1e25, q <= 1e-25, not fin) for sc, q, fin in trace]


def consensus_case(dev, seqs, bl, con, bcut, sc0):
    """The consensus of `seqs` through the pf-scale ladder from sc0, under
    the plain loops on the card and under the kernels: each attempt's scale
    and reading of Q and pout are the same, and at the last pout and Q
    agree (`consensus_agree`).  Returns (inputs, BCUT, device args, scale,
    (plain trace, kernel trace), max_abs_err of pout, ok, (Q kernel,
    Q plain))."""
    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    x = alifold._inputs(seqs, bl, con)
    n = x["n"]
    BCUT = alifold._bcut(x["S"], n) if bcut is None else bcut
    args = alifold.device_args(x, dev)
    tr_p, tr_k = [], []
    want_p, want_q, sc_p, att_p = alifold.partition(args, n, x["bsn0"], sc0, BCUT,
                                                    traced(ak.inside_outside, tr_p))
    got_p, got_q, sc_k, att_k = alifold.partition(args, n, x["bsn0"], sc0, BCUT,
                                                  traced(alifold_cuda.call_loops(), tr_k))
    err = float(np.abs(got_p.astype(np.float64) - want_p).max())
    ok = (consensus_agree(got_p, want_p, "pout") and consensus_agree(got_q, want_q, "Q")
          and (att_k, sc_k) == (att_p, sc_p) and ladder_steps(tr_k) == ladder_steps(tr_p))
    return x, BCUT, args, sc_p, (tr_p, tr_k), err, ok, (got_q, want_q)


def consensus_rows(dev, shapes):
    """The kernels at each shape: for bl True and False, a constrained call,
    BCUT 8 and 31, and the ladder from a scale at which Q overflows, held
    to the plain loops on the card (ladder and all); at the first case also
    per kernel: its outputs against the plain step's, two runs bit-equal,
    CUDA-event ms beside the plain step's ms, the bound and the dependency
    floor, and the call's host prep.  Returns {kernel: row}."""
    from dafs_tpu_torch.ops import alifold

    rows = {}
    for label, (seqs, _, bl), ss in shapes:
        n = len(seqs[0])
        con = ss if len(ss) == n else "".join("x" if k % 10 == 5 else "." for k in range(n))
        cases = [("bl", bl, None, None), ("vienna" if bl else "bl", not bl, None, None),
                 ("constrained", bl, con, None), ("BCUT 8", bl, None, 8),
                 ("BCUT 31", bl, None, 31), ("overflowing start", bl, None, None)]
        sc0 = alifold.SC0
        for k, (case, cbl, ccon, cbcut) in enumerate(cases):
            t0 = time.perf_counter()
            x, BCUT, args, sc, (tr_p, tr_k), err, ok, (gq, wq) = consensus_case(
                dev, seqs, cbl, ccon, cbcut, sc0)
            print(f"consensus {label} (NS, n) = ({len(seqs)}, {n}) {case}: BCUT {BCUT}, ladder "
                  f"attempts plain/kernel {len(tr_p)}/{len(tr_k)} from sc {float(sc0)!r} to "
                  f"{float(sc)!r}; pout max_abs_err {err!r}, Q {gq!r} against {wq!r}; within "
                  f"rtol 2e-4 (atol 1e-6 pout, 0 Q): {ok} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
            for a, ((scp, qp, fp), (sck, qk, fk)) in enumerate(zip(tr_p, tr_k)):
                print(f"  attempt {a + 1}: sc {scp!r} / {sck!r}, Q plain {qp!r} kernel {qk!r}, "
                      f"pout finite plain {fp} kernel {fk}", flush=True)
            if case == "overflowing start" and (np.isfinite(tr_p[0][1])
                                                or np.isfinite(tr_k[0][1])):
                raise AssertionError(f"consensus {label}: Q did not overflow at sc {sc0!r}")
            if not ok:
                raise AssertionError(f"consensus {label} {case}: the kernels differ from the "
                                     "plain loops")
            if k == 0:
                # later cases start warm, as the pipeline's calls do; the
                # last from the scale that takes the stable Q to 1e39
                # (Q scales as sc ** n), past float32's largest
                sc0 = sc
                sc_over = np.float32(sc * np.float32((1e39 / wq) ** (1.0 / n)))
                rows = consensus_timing(dev, label, seqs, bl, x, BCUT, args, sc, rows)
            if k == len(cases) - 2:
                sc0 = sc_over
    return rows


def device_launches(fn):
    """(kernels, copies and fills) the device ran for one call of `fn`
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = sum(nm.lower().startswith(("memcpy", "memset")) for nm in names)
    return len(names) - copies, copies


def host_s(fn):
    """Host seconds of one call of `fn`, ended by a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def consensus_timing(dev, label, seqs, bl, x, BCUT, args, sc, rows):
    """The kernels at the first case of a shape (see `consensus_rows`)."""
    import torch

    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    n, NS = x["n"], x["S"].shape[0]
    # host prep of the call and `prepare`, then the plain loops' device work
    inputs_s = host_s(lambda: alifold._inputs(seqs, bl, None))
    copies_s = host_s(lambda: alifold.device_args(x, dev))
    prepare_s = host_s(lambda: ak.prepare(*args, n, sc, x["bsn0"]))
    p = ak.prepare(*args, n, sc, x["bsn0"])
    plain_s = host_s(lambda: ak.inside_outside(p, n, BCUT=BCUT))
    plain_kernels, plain_copies = device_launches(lambda: ak.inside_outside(p, n, BCUT=BCUT))
    print(f"consensus {label} (NS, n, Lp) = ({NS}, {n}, {x['L'] + 2}), one call: host prep "
          f"_inputs {inputs_s:.4f} s, device_args {copies_s:.4f} s, prepare {prepare_s:.4f} s; "
          f"the plain loops {plain_s:.3f} s, {plain_kernels} device kernels and {plain_copies} "
          f"copies and fills", flush=True)
    out = {}
    plain_ms = {"alifold_inside": once_ms(lambda: out.update(i=ak.inside(p, n, BCUT=BCUT)))}
    qb_mat, qm, _, QBL = out["i"]
    plain_ms["alifold_exterior"] = once_ms(lambda: out.update(e=ak.exterior(p, n, qb_mat)))
    q1, qn, Q = out["e"]
    plain_ms["alifold_outside"] = once_ms(
        lambda: out.update(o=ak.outside(p, n, QBL, qm, q1, qn, Q, BCUT=BCUT)))
    pk = alifold_cuda.pack(p, n, BCUT)
    la = alifold_cuda.launch_args(pk)
    t = pk["tensors"]
    npairs = int(t["pairs"].numel())
    grids = (alifold_cuda.grid(pk, la), alifold_cuda.grid(pk, la, outside_scan=True))
    print(f"consensus {label}: {npairs} pair-allowed cells of {n * (n - 1) // 2} over "
          f"{n - 1} diagonals; grids (CTAs of 256 threads) inside {grids[0]}, outside "
          f"{grids[1]}", flush=True)
    # (run, its outputs, the plain step's, each output's tolerance kind,
    # diagonals); every run is one launch
    runs = {"alifold_inside": (lambda: alifold_cuda.inside(pk, la), lambda: (t["qbl"],),
                               (QBL[0],), ("qb",), n - 1),
            "alifold_exterior": (lambda: alifold_cuda.exterior(pk, la),
                                 lambda: (t["q1"], t["qn"], t["q"].reshape(())), (q1, qn, Q),
                                 ("q1", "qn", "Q"), None),
            "alifold_outside": (lambda: alifold_cuda.outside(pk, la), lambda: (t["pout"],),
                                (out["o"],), ("pout",), n - 1)}
    work = alifold_work(x, NS, BCUT, ak.SW * ak.SW + 2 * ak.SW + 4)
    reps = 5 if n < 200 else 3
    for name, (run, got, want, kinds, steps) in runs.items():
        kernel = alifold_kernels()[name]
        before = kernel.launches
        run()
        first = [g.clone() for g in got()]
        launched = kernel.launches - before
        run()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(first, got()))
        err = max(max_abs(g, w) for g, w in zip(got(), want))
        ok = all(consensus_agree(g, w, k) for g, w, k in zip(got(), want, kinds))
        ms = cuda_ms(run, reps)
        # the floors: one launch's grid barriers (n - 1), and the chain
        # of a launch a diagonal (as many empty launches)
        launch_floor_ms = cuda_ms(lambda: alifold_cuda.floor_probe(dev, steps or 1), reps)
        floor_ms = (cuda_ms(lambda: alifold_cuda.barrier_probe(pk, la, steps), reps)
                    if steps else launch_floor_ms)
        bound_ms, bound_by, bound_kind = bound(*work[name])
        print(f"kernel {name} {label} (NS, n, Lp) = ({NS}, {n}, {x['L'] + 2}) BCUT {BCUT}: "
              f"two runs bit-equal={exact} max_abs_err={err!r} within tolerance "
              f"({', '.join(kinds)})={ok} kernel_ms={ms:.4f} plain_ms={plain_ms[name]:.4f} "
              f"launches={launched} diagonals={steps}; floor {floor_ms:.4f} ms "
              f"({'%d grid barriers in one launch' % steps if steps else 'one empty launch'}), "
              f"{steps or 1} empty launches {launch_floor_ms:.4f} ms", flush=True)
        print(f"  bound {bound_ms:.6f} ms ({bound_by}; {work[name][0]:.4g} operations, "
              f"{work[name][1]:.4g} bytes); kernel at {bound_ms / ms:.2e} of it", flush=True)
        if not (exact and ok and launched == 1):
            raise AssertionError(f"{name} {label}: not bit-equal across runs, outside the "
                                 f"tolerance of the plain step, or {launched} launches")
        rows[name] = dict(name=name, route="cuda", source="dafs_tpu_torch/csrc/alifold.cu",
                          replaces=ALIFOLD[name][1], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms[name], bound_ms=bound_ms, bound_by=bound_by,
                          bound_kind=bound_kind, library_ms=None, floor_ms=floor_ms,
                          launch_floor_ms=launch_floor_ms, diagonals=steps,
                          launched_by="alifold_cuda.inside_outside")
    total = cuda_ms(lambda: alifold_cuda.inside_outside(p, n, BCUT=BCUT), reps)
    barriers = cuda_ms(lambda: alifold_cuda.barrier_probe(pk, la, 2 * (n - 1)), reps)
    floor = cuda_ms(lambda: alifold_cuda.floor_probe(dev, 2 * (n - 1) + 1), reps)
    print(f"consensus {label}: the three kernels {total:.4f} ms a call (pack and launches), "
          f"plain {sum(plain_ms.values()):.1f} ms; floor ({2 * (n - 1)} grid barriers) "
          f"{barriers:.4f} ms; a launch a diagonal ({2 * (n - 1) + 1} empty launches) "
          f"{floor:.4f} ms", flush=True)
    return rows


def consensus_phase(dev):
    """Family-50's whole default pipeline on two shards of one card (its
    calls recorded), then the kernel rows at RF00005's final call,
    RF00017's largest and family-50's last.  Returns (rows, {kernel: {run
    label: launches}})."""
    from dafs_tpu_torch.parallel import mesh

    by_path = {name: {} for name in all_kernels()}
    fa = family50()
    label = "family-50 default pipeline, 2 shards of one card"
    store = CONSENSUS_CALLS["family-50"] = []
    with mesh.virtual_mesh(2), recorded_consensus(store):
        res, wall, counts = timed_run(fa, dev)
    report_run(label, res, wall, counts, fa, by_path)
    consensus_summary(label, res.consensus_calls)
    SS_CONS["family-50"] = res.ss_cons
    largest = max(CONSENSUS_CALLS["RF00017_4.fa"], key=lambda c: len(c[0]) * len(c[0][0]))
    shapes = [("RF00005 final", CONSENSUS_CALLS["RF00005_0.fa"][-1], SS_CONS["RF00005_0.fa"]),
              ("RF00017 largest", largest, SS_CONS["RF00017_4.fa"]),
              ("family-50 last", store[-1], SS_CONS["family-50"])]
    return consensus_rows(dev, shapes), by_path


# ------------------------------------------------------------------- fold --
# The McCaskill fold's CUDA kernels (`csrc/mccaskill.cu`): inside and outside
# one cooperative launch an attempt each (a grid barrier between the
# diagonals), exterior one launch.  Each ladder attempt of each bucket (or
# shard of one) launches each of the three once, and the plain McCaskill
# (`mccaskill_kernel.mccaskill_fast`) never runs on a card tensor.

FOLD = {
    "mccaskill_inside": ("INSIDE", "dafs_tpu/ops/mccaskill_kernel.py:308"),
    "mccaskill_exterior": ("EXTERIOR", "dafs_tpu/ops/mccaskill_kernel.py:336"),
    "mccaskill_outside": ("OUTSIDE", "dafs_tpu/ops/mccaskill_kernel.py:494"),
}
FOLD_WATCH = {"card_runs": 0, "plain_on_card": 0}
# -Xptxas -v of each kernel source: {source: {kernel: (registers, smem bytes,
# spill bytes)}}, filled by `ptxas_report`
PTXAS: dict = {}


def fold_kernels():
    from dafs_tpu_torch.ops import mccaskill_cuda

    return {name: getattr(mccaskill_cuda, attr) for name, (attr, _) in FOLD.items()}


def watch_fold():
    """Sets to 0 the fold's ladder attempts on a card (the calls of
    `mccaskill_cuda.mccaskill`, one a bucket shard and attempt) and the
    count of the plain McCaskill's calls on card tensors (each is wrapped
    once, to count them)."""
    from dafs_tpu_torch.ops import mccaskill_cuda
    from dafs_tpu_torch.ops import mccaskill_kernel as MK

    if not getattr(MK.mccaskill_fast, "counted", False):
        plain, card = MK.mccaskill_fast, mccaskill_cuda.mccaskill

        def counted(S, *a, **k):
            if S.is_cuda:
                FOLD_WATCH["plain_on_card"] += 1
            return plain(S, *a, **k)

        def card_run(prep, sc):
            FOLD_WATCH["card_runs"] += 1
            return card(prep, sc)

        counted.counted = True
        MK.mccaskill_fast, mccaskill_cuda.mccaskill = counted, card_run
    FOLD_WATCH["card_runs"] = FOLD_WATCH["plain_on_card"] = 0


def check_fold(label, counts):
    """Since `watch_fold`: each fold kernel launched once per ladder attempt
    of each bucket shard on the card, and the plain McCaskill ran on no card
    tensor."""
    runs, plain = FOLD_WATCH["card_runs"], FOLD_WATCH["plain_on_card"]
    got = {name: counts[name] for name in FOLD}
    print(f"{label}: fold kernels {got} for {runs} ladder attempts of bucket shards on the "
          f"card; the plain McCaskill ran on card tensors {plain} times", flush=True)
    if any(v != runs for v in got.values()) or plain:
        raise AssertionError(f"{label}: fold launches {got} for {runs} ladder attempts, plain "
                             f"McCaskill on the card {plain} times")


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


def refold_constraints(snap_name):
    """Path (b)'s constrained re-folds of a family: each sequence's
    constraint from the snapshot's SS_cons projected onto its row ('(' ')'
    where both ends are bases, '?' elsewhere), as `pipeline._update_bp`
    builds them; returns (seqs, constraints)."""
    _, ss, _, rows = read_snapshot(snap_name)
    stack, pairs = [], []
    for k, ch in enumerate(ss):
        if ch == "(":
            stack.append(k)
        elif ch == ")":
            pairs.append((stack.pop(), k))
    seqs, cons = [], []
    for row in rows:
        pos = np.cumsum([c != "-" for c in row]) - 1
        seq = row.replace("-", "")
        con = ["?"] * len(seq)
        for a, b in pairs:
            if row[a] != "-" and row[b] != "-":
                con[pos[a]], con[pos[b]] = "(", ")"
        seqs.append(seq)
        cons.append("".join(con))
    return seqs, cons


def traced_fold(seqs, dev, bl, cons, sc0, plain):
    """`mccaskill.batch_bp_posteriors_fast` on the card with every ladder
    attempt traced (each row's scale, and what the ladder reads: good,
    over), its attempts run by the plain version (`plain`) or by the
    kernels.  sc0: each row's first scale (the ladder's exp(-0.6) if None):
    every attempt's scales are the ladder's times sc0 / exp(-0.6).  Returns (posteriors, trace, the last attempt: pout, Q, sc, the
    bucket's arguments and tables, and for the plain version its stages'
    CUDA-event ms and its qb, q1 and qn)."""
    import torch

    from dafs_tpu_torch.ops import mccaskill
    from dafs_tpu_torch.ops import mccaskill_kernel as MK

    real = mccaskill.fold_attempt
    trace, last = [], {}
    ratio = None if sc0 is None else torch.from_numpy(
        np.asarray(sc0, np.float32) / np.float32(np.exp(-0.6)))

    def attempt(args, sc, codes, tabs, prep=None):
        if ratio is not None:
            sc = sc * ratio.to(sc.device)
        if plain:
            ev = {k: torch.cuda.Event(enable_timing=True) for k in ("start", "inside",
                                                                    "exterior", "end")}
            ev["start"].record()
            pout, Q, parts = MK.mccaskill_fast(*args, sc, codes, tabs,
                                               stage=lambda k: ev[k].record(), parts=True)
            ev["end"].record()
            torch.cuda.synchronize()
            last["plain_ms"] = {
                "mccaskill_inside": ev["start"].elapsed_time(ev["inside"]),
                "mccaskill_exterior": ev["inside"].elapsed_time(ev["exterior"]),
                "mccaskill_outside": ev["exterior"].elapsed_time(ev["end"])}
            last["parts"] = parts
        else:
            pout, Q = real(args, sc, codes, tabs, prep)
        Qv = Q.cpu().numpy()
        fin = torch.isfinite(pout).all(dim=2).all(dim=1).cpu().numpy()
        good = np.isfinite(Qv) & (Qv > 1e-25) & (Qv < 1e25) & fin
        over = ~np.isfinite(Qv) | (Qv >= 1e25)
        trace.append((sc.cpu().numpy().tolist(), good.tolist(), over.tolist()))
        last.update(pout=pout, Q=Q, sc=sc, args=args, codes=codes, tabs=tabs, prep=prep)
        return pout, Q

    mccaskill.fold_attempt = attempt
    try:
        out = mccaskill.batch_bp_posteriors_fast(seqs, 0.0, dev, bl=bl, constraints=cons)
    finally:
        mccaskill.fold_attempt = real
    return out, trace, last


def fold_stable_scale(seqs, dev, bl=True):
    """Per-row scales at which Q lies near 1, found with the kernels (Q
    scales as sc ** n): past n of about 520 one ladder step moves Q by more
    than the ladder's window, so a long sequence starts from here."""
    import torch

    from dafs_tpu_torch import params
    from dafs_tpu_torch.ops import mccaskill, mccaskill_cuda

    L = mccaskill._round_up(max(len(s) for s in seqs), 32)
    S, PT, AP, AU, ns = mccaskill.bucket_inputs(seqs, L, len(seqs))
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    prep = mccaskill_cuda.prepare(t(S), t(PT), t(AP), t(AU), t(ns), mccaskill.kmer_codes(t(S)),
                                  params.to_device(mccaskill._fast_tabs(bl), dev))
    sc = np.full(len(seqs), np.exp(-0.6), np.float32)
    for _ in range(40):
        q = mccaskill_cuda.mccaskill(prep, t(sc))[1].cpu().numpy().astype(np.float64)
        ok = np.isfinite(q) & (q > 1e-5) & (q < 1e5)
        if ok.all():
            return sc
        step = np.where(np.isfinite(q) & (q > 1e-30), (1.0 / np.maximum(q, 1e-300)) ** (1.0 / ns),
                        10.0 ** (np.where(np.isfinite(q), 30.0, -30.0) / ns))
        sc = np.where(ok, sc, (sc * step).astype(np.float32)).astype(np.float32)
    raise AssertionError("fold: no scale with Q near 1")


def diag_to_rows(ld):
    """(B, Lp, Lp) diag-major ld[b, d, i] = M[b, i, i + d] as M."""
    import torch

    B, Lp, _ = ld.shape
    dev = ld.device
    d = torch.arange(Lp, device=dev)[:, None]
    i = torch.arange(Lp, device=dev)[None, :]
    ok = (i + d <= Lp - 1).expand(Lp, Lp)
    M = torch.zeros_like(ld)
    M[:, i.expand(Lp, Lp)[ok], (i + d).expand(Lp, Lp)[ok]] = ld[:, ok]
    return M


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


def fold_kernel_rows(label, dev, last, reps):
    """Each fold kernel at the ladder's last attempt of a case: against the
    plain step (qb, q1, qn and Q within rtol 2e-4 and a millionth of their
    largest value, pout within rtol 2e-4 / atol 1e-6), two runs bit-equal,
    one launch, CUDA-event ms beside the plain step's, the bound on these
    inputs, and the floor (the grid barriers of one launch; one empty
    launch for the exterior).  Returns {kernel: row}."""
    import torch

    from dafs_tpu_torch.ops import alifold_cuda, mccaskill_cuda

    prep, sc = last["prep"], last["sc"]
    parts = last["parts"]
    pk = mccaskill_cuda.pack(prep, sc)
    la = mccaskill_cuda.launch_args(pk)
    t = pk["tensors"]
    maxn = prep["ints"]["maxn"]
    grids = (mccaskill_cuda.grid(pk, la), mccaskill_cuda.grid(pk, la, outside_scan=True))
    npairs = int(t["pairs"].numel())
    B = prep["ints"]["nb"]
    print(f"fold {label}: (B, Lp, maxn) = ({B}, {prep['ints']['lp']}, {maxn}); {npairs} "
          f"pair-allowed cells over {maxn - 1} diagonals; grids (CTAs of 256 threads, a warp "
          f"a cell) inside {grids[0]}, outside {grids[1]}", flush=True)
    plain_pout, plain_q = last["plain_pout"], last["plain_Q"]
    runs = {
        "mccaskill_inside": (lambda: mccaskill_cuda.inside(pk, la), lambda: (diag_to_rows(t["qbl"]),),
                             (parts["qb"],), ("qb",), maxn - 1),
        "mccaskill_exterior": (lambda: mccaskill_cuda.exterior(pk, la),
                               lambda: (t["q1"], t["qn"], t["q"]),
                               (parts["q1"], parts["qn"], plain_q), ("q1", "qn", "Q"), None),
        "mccaskill_outside": (lambda: mccaskill_cuda.outside(pk, la), lambda: (t["pout"],),
                              (plain_pout,), ("pout",), maxn - 1),
    }
    work = fold_work(prep)
    rows = {}
    for name, (run, got, want, kinds, steps) in runs.items():
        kernel = fold_kernels()[name]
        before = kernel.launches
        run()
        first = [g.clone() for g in got()]
        launched = kernel.launches - before
        run()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(first, got()))
        err = max(max_abs(g, w) for g, w in zip(got(), want))
        ok = all(consensus_agree(g, w, k) for g, w, k in zip(got(), want, kinds))
        ms = cuda_ms(run, reps)
        floor_ms = (cuda_ms(lambda: mccaskill_cuda.barrier_probe(pk, la, steps), reps) if steps
                    else cuda_ms(lambda: alifold_cuda.floor_probe(dev, 1), reps))
        bound_ms, bound_by, bound_kind = bound(*work[name])
        plain_ms = last["plain_ms"][name]
        ptx = PTXAS.get("mccaskill.cu", {}).get(name.replace("mccaskill_", "") + "_kernel", {})
        print(f"kernel {name} {label}: two runs bit-equal={exact} max_abs_err={err!r} within "
              f"tolerance ({', '.join(kinds)})={ok} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"launches={launched}; floor {floor_ms:.4f} ms "
              f"({'%d grid barriers in one launch' % steps if steps else 'one empty launch'}); "
              f"bound {bound_ms:.6f} ms ({bound_by}; {work[name][0]:.4g} operations, "
              f"{work[name][1]:.4g} bytes); {ptx.get('regs')} registers, {ptx.get('smem')} "
              f"bytes smem", flush=True)
        if not (exact and ok and launched == 1):
            raise AssertionError(f"{name} {label}: not bit-equal across runs, outside the "
                                 f"tolerance of the plain step, or {launched} launches")
        rows[name] = dict(name=name, route="cuda", source="dafs_tpu_torch/csrc/mccaskill.cu",
                          replaces=FOLD[name][1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bound_kind=bound_kind,
                          library_ms=None, floor_ms=floor_ms, diagonals=steps,
                          registers=ptx.get("regs"), smem_bytes=ptx.get("smem"),
                          launched_by="mccaskill.fold_attempt")
    total = cuda_ms(lambda: mccaskill_cuda.mccaskill(prep, sc), reps)
    barriers = cuda_ms(lambda: mccaskill_cuda.barrier_probe(pk, la, 2 * (maxn - 1)), reps)
    print(f"fold {label}: the three kernels {total:.4f} ms an attempt (pack and launches), the "
          f"plain version {sum(last['plain_ms'].values()):.1f} ms; floor ({2 * (maxn - 1)} grid "
          f"barriers) {barriers:.4f} ms", flush=True)
    return rows


def fold_case(label, dev, seqs, cons=None, bl=True, start=None, reps=5):
    """The fold of `seqs` through the pf-scale ladder on the card under the
    plain version and under the kernels: every attempt at the same scales
    with the same reading (good, over) of each row, the posteriors within
    rtol 2e-4 / atol 1e-6, and at the last attempt pout and Q as
    `consensus_agree` holds them; then `fold_kernel_rows`.  start: None
    (exp(-0.6)), "over" (a scale at which every Q overflows, from the
    settled one) or "stable" (Q near 1).  Returns the kernel rows."""
    import torch

    from dafs_tpu_torch.ops import mccaskill_cuda

    t0 = time.perf_counter()
    sc0 = None
    if start == "stable":
        sc0 = fold_stable_scale(seqs, dev, bl)
    elif start == "over":
        _, _, last = traced_fold(seqs, dev, bl, cons, None, plain=False)
        sc_ok, q = last["sc"].cpu().numpy(), last["Q"].cpu().numpy().astype(np.float64)
        ns = np.array([len(s) for s in seqs], np.float64)
        sc0 = (sc_ok * (1e39 / q) ** (1.0 / ns)).astype(np.float32)
    t1 = time.perf_counter()
    want, tr_p, last_p = traced_fold(seqs, dev, bl, cons, sc0, plain=True)
    plain_s = time.perf_counter() - t1
    got, tr_k, last_k = traced_fold(seqs, dev, bl, cons, sc0, plain=False)
    err = max(float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want))
    ok = (tr_k == tr_p and consensus_agree(last_k["pout"], last_p["pout"], "pout")
          and consensus_agree(last_k["Q"], last_p["Q"], "Q")
          and all(consensus_agree(torch.from_numpy(g), torch.from_numpy(w), "pout")
                  for g, w in zip(got, want)))
    again = [x.clone() for x in mccaskill_cuda.mccaskill(last_k["prep"], last_k["sc"])]
    exact = all(torch.equal(a, b) for a, b in zip(again, mccaskill_cuda.mccaskill(
        last_k["prep"], last_k["sc"])))
    print(f"fold {label} (B, n) = ({len(seqs)}, {min(len(s) for s in seqs)}-"
          f"{max(len(s) for s in seqs)}), bl {bl}, constrained {cons is not None}, start "
          f"{start or 'exp(-0.6)'}: ladder attempts plain/kernels {len(tr_p)}/{len(tr_k)}, the "
          f"same scales and readings: {tr_k == tr_p}; posteriors max_abs_err {err!r}; Q kernels "
          f"{last_k['Q'].cpu().numpy().tolist()} plain {last_p['Q'].cpu().numpy().tolist()}; "
          f"within rtol 2e-4 (atol 1e-6 pout, 0 Q): {ok}; two runs bit-equal {exact}; the plain "
          f"ladder {plain_s:.1f}s ({time.perf_counter() - t0:.1f}s)", flush=True)
    if start == "over" and any(tr_p[0][1]):
        raise AssertionError(f"fold {label}: Q did not overflow at the start")
    if not (ok and exact):
        raise AssertionError(f"fold {label}: the kernels differ from the plain version")
    last_k.update(parts=last_p["parts"], plain_ms=last_p["plain_ms"],
                  plain_pout=last_p["pout"], plain_Q=last_p["Q"])
    return fold_kernel_rows(label, dev, last_k, reps)


def fold_phase(dev):
    """The fold kernels against the plain version on the card at the main
    path's buckets and past them; returns {kernel: row} (RF00017's numbers,
    every case's beside them under "by_case")."""
    import torch

    from dafs_tpu_torch.ops import mccaskill_cuda

    r5 = [f.seq for f in read_fasta("RF00005_0.fa")]
    r17 = [f.seq for f in read_fasta("RF00017_4.fa")]
    fam = [f.seq for f in family50()]
    con_seqs, cons = refold_constraints("rf00005_default_tpu.txt")
    rows17 = read_snapshot("rf00017_default_tpu.txt")[3]
    tiled = lambda n: [(r.replace("-", "") * (n // 290 + 1))[:n] for r in rows17[:2]]  # noqa: E731
    cases = [
        ("RF00005's fold", dict(seqs=r5)),
        ("RF00017's fold", dict(seqs=r17, reps=3)),
        ("family-50's fold", dict(seqs=fam)),
        ("a single sequence", dict(seqs=r5[:1])),
        ("path (b)'s constrained re-fold", dict(seqs=con_seqs, cons=cons)),
        ("bl=False (path (a)'s consensus parameters)", dict(seqs=r5, bl=False)),
        ("an overflowing start", dict(seqs=r5, start="over")),
        ("the length phase n 1056", dict(seqs=tiled(1056), start="stable", reps=2)),
    ]
    rows, by_case = {}, {}
    for label, kw in cases:
        got = fold_case(label, dev, **kw)
        for name, row in got.items():
            by_case.setdefault(name, {})[label] = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms", "max_abs_err")}
        if label == "RF00017's fold":
            rows = got
    # n 2048: the kernels alone, well formed and bit-equal across two runs
    t0 = time.perf_counter()
    seqs = tiled(2048)
    out, trace, last = traced_fold(seqs, dev, True, None, fold_stable_scale(seqs, dev), False)
    pout, Q = last["pout"], last["Q"]
    again = [x.clone() for x in mccaskill_cuda.mccaskill(last["prep"], last["sc"])]
    exact = all(torch.equal(a, b) for a, b in zip(again, mccaskill_cuda.mccaskill(
        last["prep"], last["sc"])))
    ms = cuda_ms(lambda: mccaskill_cuda.mccaskill(last["prep"], last["sc"]), 1)
    lo, hi = float(pout.min()), float(pout.max())
    ok = bool(torch.isfinite(Q).all()) and bool(torch.isfinite(pout).all()) and lo >= 0.0 \
        and hi <= 1.0 + 2e-4 and exact
    print(f"fold the length phase n 2048 (B 2): {len(trace)} attempt(s), Q "
          f"{Q.cpu().numpy().tolist()}, pout in [{lo!r}, {hi!r}]; the kernels {ms:.4f} ms an "
          f"attempt; two runs bit-equal {exact}; well formed: {ok} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if not ok:
        raise AssertionError("fold n 2048: not well formed or not bit-equal across runs")
    # the ladder from its first scale past n 520 (ROADMAP C.7): read, not held
    try:
        _, trace, _ = traced_fold(tiled(1056), dev, True, None, None, False)
        print(f"fold n 1056 from exp(-0.6): the ladder settled in {len(trace)} attempt(s)",
              flush=True)
    except FloatingPointError:
        print("fold n 1056 from exp(-0.6): the ladder did not settle in 16 attempts",
              flush=True)
    for name in rows:
        rows[name]["by_case"] = by_case[name]
    return rows


# ------------------------------------------------------------------ paths --

# ---------------------------------------------------------------- dd step --
# The DD loop's multiplier step (`csrc/dd_step.cu`): three kernels and one
# `torch.sum` a body in place of the plain step's ~270 ATen launches, held
# bit for bit to the plain step (`dd._step_plain`, ATen on the card).

DD_STEP = {"dd_candidates": "candidates_kernel", "dd_update": "update_kernel",
           "dd_scalars": "scalars_kernel"}
DD_RULES = ("subgradient", "adagrad", "adam")


def dd_step_kernels():
    from dafs_tpu_torch.ops import dd_step_cuda

    return {"dd_candidates": dd_step_cuda.CANDIDATES, "dd_update": dd_step_cuda.UPDATE,
            "dd_scalars": dd_step_cuda.SCALARS}


class plain_dd_step:
    """Inside the block, DD loops on the card take the plain step
    (`dd._step_plain` and the plain score matrices, ATen on the card) in
    place of the step kernels."""

    def __enter__(self):
        from dafs_tpu_torch.ops import dd_step_cuda

        self.orig = dd_step_cuda.Step
        dd_step_cuda.Step = lambda pr, st: None
        return self

    def __exit__(self, *exc):
        from dafs_tpu_torch.ops import dd_step_cuda

        dd_step_cuda.Step = self.orig
        return False


def dd_layers(fa, dev, **kw):
    """The batched DD of every guide-tree layer of one `align_and_fold` run
    on `dev`: [(problems, solver keywords)], in the order solved."""
    from dafs_tpu_torch import align_and_fold, dd

    layers = []
    orig = dd.solve_by_dd_batch

    def solve(problems, **solve_kw):
        layers.append((problems, {k: v for k, v in solve_kw.items() if k != "stats"}))
        return orig(problems, **solve_kw)

    dd.solve_by_dd_batch = solve
    try:
        align_and_fold(fa, device=dev, **kw)
    finally:
        dd.solve_by_dd_batch = orig
    return layers


def dd_state(problems, kw, rule, plain=False):
    """(prep_batch's tensors, a `dd._State`) of one layer on kw["device"]
    under `rule`, with the step kernels or (plain) the plain step."""
    from dafs_tpu_torch import dd

    pr = dd.prep_batch(problems, w=kw["w"], th_s=kw["th_s"], th_a=kw["th_a"],
                       device=kw["device"])
    f = np.float32
    core = dict(th_s0=float(f(kw["th_s"][0])), th_a=float(f(kw["th_a"])),
                eta0=float(f(kw["eta0"])), t_max=kw["t_max"], update_rule=rule)
    if plain:
        with plain_dd_step():
            return pr, dd._State(pr, **core)
    return pr, dd._State(pr, **core)


def same_bits(u, v) -> bool:
    """Whether two tensors hold the same bits (-0.0 is not 0.0)."""
    import torch

    if u.dtype == torch.float32:
        u, v = u.view(torch.int32), v.view(torch.int32)
    return torch.equal(u, v)


def dd_states_equal(a, b) -> list:
    """The names of the state arrays in which two `dd._State`s differ in
    any bit (the optimiser planes as opt0, opt1, ...)."""
    names = ("q_x", "q_y", "q_z", "eta", "c", "s_prev", "violated", "t", "x", "y", "z", "done")
    pairs = [(n, getattr(a, n), getattr(b, n)) for n in names]
    pairs += [(f"opt{k}", u, v) for k, (u, v) in enumerate(zip(a.opt, b.opt))]
    return [n for n, u, v in pairs if not same_bits(u, v)]


def compare_dd_bodies(problems, kw, rule, bodies):
    """Runs `bodies` loop bodies of one layer on the card through the step
    kernels and through the plain step; raises unless after every body the
    two states are bit-equal (q, the optimiser state, eta, c, s_prev, t,
    violated, x, y, z, done) and the kernels' score matrices for the next
    body are the plain version's.  Returns the merges done at the end."""
    from dafs_tpu_torch import dd

    _, k = dd_state(problems, kw, rule)
    _, p = dd_state(problems, kw, rule, plain=True)
    if k.kernels is None or p.kernels is not None:
        raise AssertionError("dd_state did not give the two routes")
    for body in range(bodies):
        dd._body(k)
        dd._body(p)
        bad = dd_states_equal(k, p)
        sm_xy, sm_z = dd._scores_plain(p)
        bad += [n for n, u, v in (("sm_xy", k.sm_xy, sm_xy), ("sm_z", k.sm_z, sm_z))
                if not same_bits(u, v)]
        if bad:
            raise AssertionError(f"DD step, {rule}, B {k.B} P1 {k.P1} P2 {k.P2}: body {body} "
                                 f"differs from the plain step in {bad}")
    return int(k.done.sum())


def solve_both_routes(problems, kw, rule):
    """One layer's `solve_by_dd_batch` on the card through the step kernels
    and through the plain step: (solutions, stats) of each."""
    from dafs_tpu_torch import dd

    out = []
    for plain in (False, True):
        stats = []
        kw2 = {**kw, "update_rule": rule, "stats": stats}
        if plain:
            with plain_dd_step():
                sols = dd.solve_by_dd_batch(problems, **kw2)
        else:
            sols = dd.solve_by_dd_batch(problems, **kw2)
        out.append((sols, stats))
    return out


def dd_solutions_equal(a, b) -> bool:
    (sa, ta), (sb, tb) = a, b
    return ta == tb and all(
        np.float32(u[0]).tobytes() == np.float32(v[0]).tobytes()
        and all(np.array_equal(x, y) for x, y in zip(u[1:], v[1:])) for u, v in zip(sa, sb))


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


def dd_step_rows(label, problems, kw, dev, reps=50):
    """The step kernels at one layer's batch, every merge running: each
    kernel's device ms, the whole step's ms as the loop launches it and its
    device ms, the plain step's ms, the bound, the floor (one empty launch)
    and the launches a body; returns {kernel: row}."""
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

    def step():
        st.done.copy_(done0)
        st.kernels(s_xy, xy, s_z, z_new)

    def plain():
        vars(pl).update(saved)
        dd._step_plain(pl, s_xy, xy, s_z, z_new)

    before = {n: k.launches for n, k in dd_step_kernels().items()}
    step()
    per_body = {n: k.launches - before[n] for n, k in dd_step_kernels().items()}
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
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    B, P1, P2 = pr["p_z"].shape
    shape = f"B {B}, P1 {P1}, P2 {P2}, U {pr['cbp'].shape[1]}"
    print(f"dd step {label} ({shape}, {rule}): {ms:.4f} ms a body as the loop launches it "
          f"({sum(per_body.values())} launches + one torch.sum, and a copy of done that keeps "
          f"every merge running), {dev_ms:.4f} ms on the device "
          f"(queued behind a {spin_ms:.1f} ms spin in {host_ms:.1f} ms of host); plain step "
          f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({nbytes} bytes); floor {floor_ms:.4f} ms "
          f"(one empty launch)", flush=True)
    if set(per_body.values()) != {1}:
        raise AssertionError(f"dd step {label}: launches a body {per_body}")
    rows = {}
    for name, fn in parts.items():
        part_ms = queued_ms(fn, reps)[0]
        rows[name] = dict(name=name, route="cuda", source="dafs_tpu_torch/csrc/dd_step.cu",
                          replaces="none (XLA fused dafs_tpu/dd.py::_dd_core's body)",
                          shape=shape, rule=rule, ms=part_ms, step_ms=ms,
                          step_device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes", floor_ms=floor_ms, launches_per_body=1,
                          max_abs_err=0.0, library_ms=None, launched_by="dd._step")
        print(f"  kernel {name}: {part_ms:.4f} ms on the device"
              + (" (with the 1-byte-a-merge copy of done that keeps every merge running)"
                 if name == "dd_scalars" else ""), flush=True)
    return rows


def dd_step_phase(dev):
    """The step kernels at RF00005's merge layers and family-50's first and
    last: bit-equal to the plain step body by body under each rule, whole
    solves equal under subgradient, and timed; returns {kernel: row} (the
    last shape's, every shape's under "by_case")."""
    t0 = time.perf_counter()
    cases = [(f"RF00005 layer {i}", lay) for i, lay in
             enumerate(dd_layers(read_fasta("RF00005_0.fa"), dev))]
    fam = dd_layers(family50(), dev)
    cases += [("family-50 first layer", fam[0]), ("family-50 last layer", fam[-1])]
    print(f"dd step: captured {len(cases)} layers in {time.perf_counter() - t0:.1f}s", flush=True)
    rows, by_case = {}, {}
    for label, (problems, kw) in cases:
        for rule in DD_RULES:
            done = compare_dd_bodies(problems, kw, rule, 40)
            print(f"dd step {label}, {rule}: 40 bodies bit-equal to the plain step "
                  f"({done} of {len(problems)} merges done)", flush=True)
        got, want = solve_both_routes(problems, kw, "subgradient")
        if not dd_solutions_equal(got, want):
            raise AssertionError(f"dd step {label}: solve_by_dd_batch differs from the plain step")
        print(f"dd step {label}: solve_by_dd_batch equals the plain step's; iterations "
              f"{[t for t, _ in got[1]]}", flush=True)
        rows = dd_step_rows(label, problems, kw, dev)
        for name, row in rows.items():
            by_case.setdefault(name, {})[label] = {
                k: row[k] for k in ("shape", "ms", "step_ms", "step_device_ms",
                                    "plain_ms", "bound_ms", "floor_ms")}
    for name, row in rows.items():
        row["by_case"] = by_case[name]
    return rows


# --------------------------------------------------------------- pair-CRF --
# The CONTRAlign pair-CRF's kernels (csrc/paircrf.cu).  Operations a cell:
# forward 12 log-adds and 26 adds and multiplies, backward 12 log-adds, 5
# maxima and 30 adds and multiplies, posterior five Fast_Exps and 5
# operations each, the clamp's two.

CRF_FORWARD_OPS = 12 * LOG_ADD_OPS + 26
CRF_BACKWARD_OPS = 12 * LOG_ADD_OPS + 35
CRF_POSTERIOR_OPS = 5 * (EXP_OPS + 5) + 2
PAIRCRF = ("paircrf_forward", "paircrf_backward", "paircrf_posterior")


def paircrf_kernels():
    from dafs_tpu_torch.ops import paircrf_cuda

    return {"paircrf_forward": paircrf_cuda.FORWARD, "paircrf_backward": paircrf_cuda.BACKWARD,
            "paircrf_posterior": paircrf_cuda.POSTERIOR}


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


def paircrf_inputs(seqs1, seqs2, dev, l1max=None, l2max=None):
    """The pair-CRF's inputs as `paircrf.batch_posteriors` builds them, at
    the 32-buckets of the longest sequences unless given."""
    import torch

    from dafs_tpu_torch.ops import paircrf

    l1max = l1max or -(-max(map(len, seqs1)) // 32) * 32
    l2max = l2max or -(-max(map(len, seqs2)) // 32) * 32
    c1, n1 = paircrf.encode_batch(seqs1, l1max)
    c2, n2 = paircrf.encode_batch(seqs2, l2max)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


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


def paircrf_phase(dev):
    """The pair-CRF kernels at RF00005's bucket and at contra-trna's largest
    batch: the posteriors bit-equal to the plain version on the card, each
    kernel's CUDA-event ms, the codes-to-posteriors path's, beside the plain
    version's (one call: it has no separate passes), each kernel's bound,
    and the chain floor (`paircrf_cuda.floor_probe`: as many diagonals as
    the longest pair has, the backward M chain and the hand-over alone, at
    the passes' warps).  Returns {kernel: row}, each row at the last shape
    with both under `by_case`."""
    import torch

    from dafs_tpu_torch.ops import paircrf, paircrf_cuda

    rows, by_case = {}, {name: {} for name in PAIRCRF}
    for label, args in paircrf_shapes(dev):
        tab = paircrf.tables(dev)
        B, imax = args[0].shape
        want = paircrf.forward_backward_posterior_plain(*args, tab)
        exact, err = same((paircrf.forward_backward_posterior(*args, tab),), (want,))
        plain_ms = once_ms(lambda: paircrf.forward_backward_posterior_plain(*args, tab))
        path_ms = cuda_ms(lambda: paircrf.forward_backward_posterior(*args, tab), 20)
        steps = int((args[1] + args[3]).max()) + 1
        nw = paircrf_cuda.warps(imax)
        buf = torch.zeros(B * 32 * nw, dtype=torch.float32, device=dev)
        floor_ms = cuda_ms(lambda: paircrf_cuda.floor_probe(buf, steps, nw, B), 20)
        print(f"kernel paircrf {label} B={B} L={imax - 1}: posteriors bit-equal={exact} "
              f"max_abs_err={err!r}; codes to posteriors {path_ms:.4f} ms (the two passes "
              f"side by side, then the posterior kernel), the plain version {plain_ms:.1f} ms; "
              f"floor {floor_ms:.4f} ms ({steps} diagonals of four dependent log-adds and "
              f"the hand-over, {nw} warps)", flush=True)
        if not exact:
            raise AssertionError(f"paircrf {label}: the kernels differ from the plain "
                                 f"version (max_abs_err {err})")
        F = paircrf_cuda.forward(*args, tab)
        Bm = paircrf_cuda.backward(*args, tab)
        for name, fn in (("paircrf_forward", lambda: paircrf_cuda.forward(*args, tab)),
                         ("paircrf_backward", lambda: paircrf_cuda.backward(*args, tab)),
                         ("paircrf_posterior",
                          lambda: paircrf_cuda.posterior(F, Bm, *args, tab))):
            ms = cuda_ms(fn, 20)
            bound_ms, bound_by, bound_kind = paircrf_bound(args, name)
            floor = None if name == "paircrf_posterior" else floor_ms
            print(f"  {name}: {ms:.4f} ms; bound {bound_ms:.6f} ms ({bound_by}), kernel at "
                  f"{bound_ms / ms:.2e} of it" + (f"; floor {floor:.4f} ms, kernel at "
                                                  f"{ms / floor:.2f} times it" if floor else ""))
            case = dict(shape=f"B={B}, L={imax - 1}", ms=ms, plain_ms=plain_ms, path_ms=path_ms,
                        bound_ms=bound_ms, floor_ms=floor)
            by_case[name][label] = case
            rows[name] = dict(name=name, route="cuda", source="dafs_tpu_torch/csrc/paircrf.cu",
                              replaces="dafs_tpu/ops/paircrf.py:58 (XLA scans)",
                              max_abs_err=err, bound_by=bound_by, bound_kind=bound_kind,
                              library_ms=None,
                              launched_by="paircrf_cuda.forward_backward_posterior", **case)
    for name, row in rows.items():
        row["by_case"] = by_case[name]
    return rows


CONTRA = dict(align_model="CONTRAlign", fold_model="CONTRAfold")
BP_UPDATE = dict(use_bp_update=True, use_bp_update1=True)
# (path, align_and_fold keywords, family, dafs_tpu's CPU output of it)
PATH_RUNS = [
    ("a", CONTRA, "RF00005_0.fa", "rf00005_contrafold_contralign_cpu.txt"),
    ("a", CONTRA, "RF00017_4.fa", "rf00017_contrafold_contralign_cpu.txt"),
    ("b", BP_UPDATE, "RF00005_0.fa", "rf00005_bp_update_cpu.txt"),
]
PAIRHMM = ("pairhmm_forward", "pairhmm_backward", "pairhmm_posterior")


def check_balanced(name, ss):
    depth = 0
    for ch in ss:
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth < 0:
            break
    if depth != 0 or set(ss) - set("()."):
        raise AssertionError(f"{name}: SS_cons is not a balanced structure: {ss}")


def plain_models_on_card(dev):
    """CONTRAfold (plain PyTorch on the card) and the pair-CRF (its kernels
    on the card, the plain version on the CPU) against the same calls on
    the CPU, at RF00005's bucket."""
    from dafs_tpu_torch.ops import contrafold, paircrf

    seqs = [f.seq for f in read_fasta("RF00005_0.fa")]
    cf = [contrafold.batch_bp_posteriors(seqs[:2], 0.0, d) for d in (dev, "cpu")]
    s1, s2 = [seqs[0], seqs[3], seqs[7]], [seqs[5], seqs[1], seqs[9]]
    crf = [paircrf.batch_posteriors(s1, s2, 0.0, d) for d in (dev, "cpu")]
    for name, (got, want), tol in (("plain CONTRAfold", cf, 1e-5), ("pair-CRF", crf, 1e-6)):
        err = max(float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want))
        print(f"{name} on the card against its CPU run: max_abs_err={err!r} "
              f"(bound {tol})")
        if not err <= tol:
            raise AssertionError(f"{name}: the card's run differs from the CPU's")


def paths_phase(dev):
    """Runs PATH_RUNS; returns {kernel name: {run label: launches}}."""
    plain_models_on_card(dev)
    by_path = {name: {} for name in all_kernels()}
    for path, kw, fa_name, ref_name in PATH_RUNS:
        label = f"path ({path}) {fa_name}"
        fa = read_fasta(fa_name)
        res, wall, counts = timed_run(fa, dev, **kw)
        for name, n in counts.items():
            by_path[name][label] = n
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
        print(f"{label}: {wall:.3f}s wall; {phases}")
        if path == "a":
            print(f"{label}: plain CONTRAfold (fold phase) {res.phase_seconds['fold']:.3f}s, "
                  f"the pair-CRF kernels (align phase) {res.phase_seconds['align']:.3f}s")
        consensus_summary(label, res.consensus_calls)
        print(f"{label} launch counts: {counts}")
        check_consensus(label, res.consensus_calls, counts)
        need = ("nussinov", "nw") + (PAIRHMM if path == "b" else PAIRCRF)
        for name in need:
            if counts[name] <= 0:
                raise AssertionError(f"{label}: kernel {name} was not launched")
        if path == "a" and any(counts[name] for name in PAIRHMM):
            raise AssertionError(f"{label}: a pair-HMM kernel ran under CONTRAlign")
        if path == "b" and any(counts[name] for name in PAIRCRF):
            raise AssertionError(f"{label}: a pair-CRF kernel ran under ProbCons")
        check_rows(res, fa)
        check_balanced(label, res.ss_cons)
        ref, ref_ss, ref_names, ref_rows = read_snapshot(ref_name)
        if NUM.sub("#", res.tree) != NUM.sub("#", ref):
            raise AssertionError(f"{label} tree topology differs from dafs_tpu's:\n"
                                 f"{res.tree}\n{ref}")
        digits = max(abs(float(a) - float(b)) for a, b in
                     zip(NUM.findall(res.tree), NUM.findall(ref)))
        if res.names != ref_names:
            raise AssertionError(f"{label}: names differ from the reference's")
        ss_ok, ss_all = columns_agreeing(res.ss_cons, ref_ss)
        row_ok = [columns_agreeing(r, w) for r, w in zip(res.rows, ref_rows)]
        print(f"{label} tree topology equals dafs_tpu's (CPU); largest score difference "
              f"{digits!r}; SS_cons {ss_ok} of {ss_all} columns agree (lengths "
              f"{len(res.ss_cons)} and {len(ref_ss)}); rows {sum(a for a, _ in row_ok)} of "
              f"{sum(b for _, b in row_ok)} columns agree, "
              f"{sum(r == w for r, w in zip(res.rows, ref_rows))} of {len(ref_rows)} rows "
              f"identical; SS_cons {res.ss_cons}")
    return by_path


# ---------------------------------------------------------------- solvers --
# The host merge solvers (`--ipknot`, `-m 0`, `-v 2`, `dd_host`): the serial
# merge recursion, one merge at a time, with K3 and K4 in every host DD
# iteration.

SOLVER_RUNS = [
    ("c", ["--ipknot"], "rf00005_ipknot_cpu.txt"),
    ("d", ["-m", "0"], "rf00005_ilp_cpu.txt"),
]


def cli_options(flags):
    """The `align_and_fold` keywords the port's CLI builds from `flags`: every
    `pipeline.Options` field, the models, the aux inputs and `-P`."""
    import dataclasses

    from dafs_tpu_torch import cli

    args = cli.build_parser().parse_args([*flags, "x.fa"])
    return dict(dataclasses.asdict(cli.options_from_args(args)),
                align_model=args.align_model, fold_model=args.fold_model,
                align_aux=args.align_aux, fold_aux=args.fold_aux, param_file=args.param_file)


def check_levels(name, ss):
    """Each bracket level of a (pseudoknotted) structure is balanced."""
    from dafs_tpu_torch.decoders_ip.ipknot import LEFT, RIGHT

    for lo, hi in zip(LEFT, RIGHT):
        depth = 0
        for ch in ss:
            depth += (ch == lo) - (ch == hi)
            if depth < 0:
                break
        if depth != 0:
            raise AssertionError(f"{name}: bracket level {lo}{hi} of SS_cons is not balanced: {ss}")
    if set(ss) - set(LEFT) - set(RIGHT) - {"."}:
        raise AssertionError(f"{name}: SS_cons holds other characters: {ss}")


def timed_run(fa, dev, **kw):
    """(result, wall, launch counts) of one `align_and_fold` run, the counts
    set to 0 just before it."""
    import torch

    from dafs_tpu_torch import align_and_fold

    for k in all_kernels().values():
        k.launches = 0
    watch_fold()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align_and_fold(fa, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {name: k.launches for name, k in all_kernels().items()}


def all_kernels():
    """Every kernel whose launches a run counts: the default path's, the
    long variants and the pair-CRF's (path (a) only)."""
    return {**kernels(), **long_kernels(), **paircrf_kernels()}


def against_reference(label, res, ref_name):
    """Holds the tree topology to a recorded output; prints the agreeing
    SS_cons and row columns."""
    ref, ref_ss, ref_names, ref_rows = read_snapshot(ref_name)
    if NUM.sub("#", res.tree) != NUM.sub("#", ref):
        raise AssertionError(f"{label} tree topology differs:\n{res.tree}\n{ref}")
    if res.names != ref_names:
        raise AssertionError(f"{label}: names differ from the reference's")
    ss_ok, ss_all = columns_agreeing(res.ss_cons, ref_ss)
    row_ok = [columns_agreeing(r, w) for r, w in zip(res.rows, ref_rows)]
    print(f"{label} tree topology equals {ref_name}'s; SS_cons {ss_ok} of {ss_all} columns "
          f"agree; rows {sum(a for a, _ in row_ok)} of {sum(b for _, b in row_ok)} columns "
          f"agree, {sum(r == w for r, w in zip(res.rows, ref_rows))} of {len(ref_rows)} rows "
          f"identical; SS_cons {res.ss_cons}", flush=True)


def replay_rf00017(dev):
    """The RF00017 frozen replay (tests/test_rf00017_replay.py) through the
    port's host-loop DD with the Nussinov decoder on the card: the recorded
    posteriors, similarity and consensus matrices, the names of
    tests/data/RF00017_4.fa.  Returns (wall, iterations, launch counts,
    phase seconds); raises unless the tree line, SS_cons and every row equal
    the frozen output."""
    import hashlib

    import torch

    from dafs_tpu_torch import guide_tree, pipeline
    from dafs_tpu_torch.typedefs import gapped_seq

    data = np.load(os.path.join(SNAP, "rf00017_replay.npz"))
    fa = read_fasta("RF00017_4.fa")
    if [f.name for f in fa] != list(data["names"]) or [f.seq for f in fa] != list(data["seqs"]):
        raise AssertionError("tests/data/RF00017_4.fa differs from the replay's family")
    calls = iter(range(int(data["n_ali_calls"])))

    def aln_key(aln, constraint=None):
        h = hashlib.sha256()
        for row in aln:
            h.update(str(row.seq_id).encode())
            h.update(np.asarray(row.mask, np.uint8).tobytes())
        if constraint:
            h.update(constraint.encode())
        return h.hexdigest()[:16]

    class ReplayAlifold:
        def consensus_bp(self, aln, fa_, device, constraint=None):
            i = next(calls)
            if str(data[f"ali_key_{i}"]) != aln_key(aln, constraint):
                raise AssertionError(f"replay: consensus call {i} diverged from the recorded trace")
            return data[f"ali_out_{i}"]

    d = pipeline.Dafs(None, None, pipeline.Options(dd_host=True),
                      alifold_model=ReplayAlifold(), device=dev)
    d.fa, d.mp, d.bp = fa, data["mp"], data["bp"]
    d.tree = guide_tree.build_tree(data["sim"])
    for k in all_kernels().values():
        k.launches = 0
    watch_fold()
    phases = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, aln = d._align(len(d.tree) - 1, phases)
    p = d._avg_bp(aln, use_alifold=True)
    _, sstr = d._decode_structure(p, d.o.th_s1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in all_kernels().items()}
    iters = sum(n for n, _ in d.host_dd)
    lines = str(data["output"]).splitlines()
    rows = {"> " + fa[r.seq_id].name: gapped_seq(fa[r.seq_id].seq, r.mask) for r in aln}
    tree = guide_tree.print_tree(d.tree, [f.name for f in fa])
    same_rows = sum(rows[n] == r for n, r in zip(lines[3::2], lines[4::2]))
    print(f"replay RF00017: {wall:.3f}s wall; {iters} DD iterations over {len(d.host_dd)} "
          f"merges; launches {counts}; tree "
          f"{'equal' if tree == lines[0] else 'DIFFERS'}; SS_cons "
          f"{'equal' if sstr == lines[2] else 'DIFFERS'}; rows equal {same_rows} of "
          f"{len(lines[3::2])}", flush=True)
    if tree != lines[0] or sstr != lines[2] or same_rows != len(lines[3::2]):
        raise AssertionError("replay RF00017: the output differs from the frozen output")
    if counts["nw"] != iters or counts["nussinov"] != iters + 1:
        raise AssertionError(f"replay RF00017: {iters} iterations but launches {counts}")
    check_fold("replay RF00017", counts)
    return wall, iters, counts, phases


def solvers_phase(dev):
    """Paths (c) `--ipknot` and (d) `-m 0` on RF00005 against dafs_tpu's CPU
    output, (e) `-v 2` against `dd_host=True`, and (f) the RF00017 frozen
    replay.  Returns {kernel name: {run label: launches}}."""
    import contextlib
    import io

    import scipy

    from dafs_tpu_torch.decoders_ip import ipknot

    try:
        binding = ipknot._highs_core().__name__
    except ImportError:
        binding = "none (per-iteration milp)"
    print(f"scipy {scipy.__version__}; HiGHS binding for the IPknot models: {binding}",
          flush=True)
    by_path = {name: {} for name in all_kernels()}
    fa = read_fasta("RF00005_0.fa")

    def report(label, res, wall, counts):
        """Returns the host DD iterations of the run."""
        for name, n in counts.items():
            by_path[name][label] = n
        iters = sum(n for n, _ in res.host_dd)
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
        print(f"{label}: {wall:.3f}s wall; {iters} host DD iterations over {len(res.host_dd)} "
              f"merges (iterations, violations at exit: {res.host_dd}); {phases}", flush=True)
        consensus_summary(label, res.consensus_calls)
        print(f"{label} launch counts: {counts}", flush=True)
        check_consensus(label, res.consensus_calls, counts)
        check_rows(res, fa)
        check_levels(label, res.ss_cons)
        return iters

    for path, flags, ref_name in SOLVER_RUNS:
        label = f"path ({path}) {' '.join(flags)} RF00005_0.fa"
        res, wall, counts = timed_run(fa, dev, **cli_options(flags))
        iters = report(label, res, wall, counts)
        against_reference(label, res, ref_name)
        if path == "c" and (counts["nw"] != iters or counts["nussinov"] != 0 or iters == 0):
            raise AssertionError(f"{label}: K4 launches {counts['nw']} for {iters} iterations")
        if path == "d" and (counts["nw"] != 0 or res.host_dd):
            raise AssertionError(f"{label}: the exact ILP launched K4 or ran a DD loop")
        _, ref_ss, _, ref_rows = read_snapshot(ref_name)
        if path == "d" and (res.ss_cons != ref_ss or res.rows != ref_rows):
            raise AssertionError(f"{label}: SS_cons or rows differ from {ref_name}")

    label = "path (e) -v 2 RF00005_0.fa"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, wall, counts = timed_run(fa, dev, **cli_options(["-v", "2"]))
    iters = report(label, res, wall, counts)
    dumps = buf.getvalue()
    host, host_wall, host_counts = timed_run(fa, dev, dd_host=True)
    print(f"path (e) dd_host=True RF00005_0.fa: {host_wall:.3f}s wall; launch counts "
          f"{host_counts}", flush=True)
    check_consensus("path (e) dd_host=True RF00005_0.fa", host.consensus_calls, host_counts)
    blocks = dumps.count("\n\n")
    print(f"{label}: {len(dumps)} bytes of dumps, {blocks} blocks for {iters} iterations; "
          f"output {'equals' if str(res) == str(host) else 'DIFFERS from'} the dd_host run's",
          flush=True)
    if str(res) != str(host) or blocks != iters or counts["nw"] != iters:
        raise AssertionError(f"{label}: dumps or output differ from the dd_host run")

    wall, iters, counts, phases = replay_rf00017(dev)
    for name, n in counts.items():
        by_path[name]["replay RF00017"] = n
    print(f"replay RF00017 phases: {', '.join(f'{k} {v:.3f}s' for k, v in phases.items())}")
    return by_path


# ---------------------------------------------------------------- options --
# The last single-card options of `dafs_tpu`: refinement (`-r`), four-way PCT
# (`-f`), the adagrad and adam DD updates, the aux files and a parameter file
# (`-P`), each through `align_and_fold` with the keywords the port's CLI
# builds, K1-K4 on the path of every run but the aux reload's.

PAR_FILE = os.path.join(DATA, "ml_ninio.par")
T_MAX = 600
# (run, CLI flags, dafs_tpu's CPU output of it on RF00005)
OPTION_RUNS = [
    ("g", ["-r", "2"], "rf00005_refine2_cpu.txt"),
    ("h", ["-f", "0.5"], "rf00005_fourway_cpu.txt"),
    ("i", ["--dd-update", "adagrad"], "rf00005_adagrad_cpu.txt"),
    ("j", ["--dd-update", "adam"], "rf00005_adam_cpu.txt"),
    ("l", ["-P", PAR_FILE], "rf00005_param_file_cpu.txt"),
]
# the default path's RF00005 output of the slice phase
SLICE_OUTPUT: dict = {}


def report_run(label, res, wall, counts, fa, by_path, need=PAIRHMM + ("nussinov", "nw")):
    """Prints a run's wall, phase split, DD merges and launches; checks rows,
    balance and the launches of `need`."""
    for name, n in counts.items():
        by_path[name][label] = n
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
    iters = sum(t for t, _ in res.device_dd)
    print(f"{label}: {wall:.3f}s wall; {phases}; device DD {iters} iterations over "
          f"{len(res.device_dd)} merges (iterations, violations at exit: {res.device_dd}); "
          f"launch counts {counts}", flush=True)
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    check_consensus(label, res.consensus_calls, counts)
    check_rows(res, fa)
    check_balanced(label, res.ss_cons)


def against_snapshot(label, res, ref_name):
    """The tree topology against dafs_tpu's CPU output; SS_cons and rows too
    where no merge stopped at the iteration cap."""
    against_reference(label, res, ref_name)
    capped = [m for m in res.device_dd if m[0] >= T_MAX and m[1] > 0]
    _, ref_ss, _, ref_rows = read_snapshot(ref_name)
    if not capped and (res.ss_cons != ref_ss or res.rows != ref_rows):
        raise AssertionError(f"{label}: no merge was capped, yet SS_cons or rows differ "
                             f"from {ref_name}")
    print(f"{label}: {len(capped)} merges stopped at the {T_MAX}-iteration cap; "
          f"{'columns printed above' if capped else 'SS_cons and rows equal the snapshot'}",
          flush=True)


def check_refinements(label, res):
    for k, r in enumerate(res.refinements):
        print(f"{label} refinement {k + 1}: groups {r['groups'][0]} | {r['groups'][1]}; "
              f"s_new {r['s_new']!r} against s {r['s']!r} -> "
              f"{'kept' if r['s_new'] > r['s'] else 'dropped'}", flush=True)
    if not res.refinements or not res.score >= res.refinements[0]["s"]:
        raise AssertionError(f"{label}: final score {res.score!r} below the score before "
                             "refinement")


def fourway_on_card(dev, fa):
    """Four-way PCT on RF00005's own posteriors, the card against the port's
    CPU version (1e-6)."""
    from dafs_tpu_torch import consistency
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.typedefs import CUTOFF

    lens = [len(f) for f in fa]
    bp = fold_models.by_name("Boltzmann", CUTOFF).all_seqs(fa, dev)
    mp = align_models.by_name("ProbCons", 0.01).all_pairs(fa, dev)
    card = consistency.relax_fourway_consistency(mp, bp, lens, 0.5, dev)
    ms = once_ms(lambda: consistency.relax_fourway_consistency(mp, bp, lens, 0.5, dev))
    t0 = time.perf_counter()
    cpu = consistency.relax_fourway_consistency(mp, bp, lens, 0.5, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(card.astype(np.float64) - cpu).max())
    moved = int(((mp > CUTOFF) != (cpu > CUTOFF)).sum())
    sides = int(((card > CUTOFF) != (cpu > CUTOFF)).sum())
    print(f"four-way PCT on RF00005 (45 pairs, L {max(lens)}): card against CPU "
          f"max_abs_err={err!r} (bound 1e-6); {moved} entries cross CUTOFF under the "
          f"transform, {sides} fall on different sides on the card and the CPU; "
          f"{ms:.3f} ms on the card (with the copies), {cpu_ms:.1f} ms on the CPU", flush=True)
    if not err <= 1e-6:
        raise AssertionError("four-way PCT: the card's result differs from the CPU's")


class recorded_posteriors:
    """Records the posteriors every model returns (`mp` and `bp`) while on."""

    def __init__(self, store):
        from dafs_tpu_torch.models import align_models, fold_models

        self.store = store
        self.targets = [(align_models.AlignModel, "all_pairs", "mp"),
                        (align_models.AUXAlign, "all_pairs", "mp"),
                        (fold_models.FoldModel, "all_seqs", "bp"),
                        (fold_models.AUXFold, "all_seqs", "bp")]

    def __enter__(self):
        self.saved = [getattr(cls, name) for cls, name, _ in self.targets]
        for (cls, name, key), fn in zip(self.targets, self.saved):
            def rec(*a, _fn=fn, _key=key, **kw):
                out = _fn(*a, **kw)
                self.store[_key] = out.copy()
                return out
            setattr(cls, name, rec)
        return self.store

    def __exit__(self, *exc):
        for (cls, name, _), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)


def aux_round_trip(dev, fa, by_path):
    """(k): dump the posteriors, then run again from the dumps."""
    import shutil

    d = os.path.join(ROOT, "build", "chip_smoke_aux")
    os.makedirs(d, exist_ok=True)
    mp_path, bp_path = os.path.join(d, "mp.txt"), os.path.join(d, "bp.txt")
    try:
        first_arrays, again_arrays = {}, {}
        with recorded_posteriors(first_arrays):
            first, wall, counts = timed_run(fa, dev, **cli_options(
                ["--save-align-aux", mp_path, "--save-fold-aux", bp_path]))
        report_run("(k) --save-align-aux --save-fold-aux RF00005_0.fa", first, wall, counts,
                   fa, by_path)
        sizes = [os.path.getsize(p) for p in (mp_path, bp_path)]
        with recorded_posteriors(again_arrays):
            again, wall, counts = timed_run(fa, dev, **cli_options(
                ["--align-aux", mp_path, "--fold-aux", bp_path]))
        label = "(k) --align-aux --fold-aux RF00005_0.fa"
        report_run(label, again, wall, counts, fa, by_path, need=("nussinov", "nw"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = {k: bool(np.array_equal(first_arrays[k], again_arrays[k])) for k in ("mp", "bp")}
    print(f"(k) dumps of {sizes[0]} and {sizes[1]} bytes; read back bit-equal to the first "
          f"run's: {same}; reload's tree {'equal' if again.tree == first.tree else 'DIFFERS'}, "
          f"SS_cons {'equal' if again.ss_cons == first.ss_cons else 'DIFFERS'}, rows "
          f"{'equal' if again.rows == first.rows else 'DIFFER'}", flush=True)
    if not all(same.values()):
        raise AssertionError("(k): the aux files do not read back the first run's posteriors")
    if any(counts[name] for name in PAIRHMM):
        raise AssertionError(f"(k): a pair-HMM kernel ran in the reload: {counts}")
    if (again.tree, again.ss_cons, again.rows) != (first.tree, first.ss_cons, first.rows):
        raise AssertionError("(k): the reload's output differs from the first run's")


def param_file_runs(dev, fa, by_path, flags, ref_name):
    """(l): `-P` with the test's parameter file, then the overrides reset and
    a default run."""
    from dafs_tpu_torch.ops import energy_params, mccaskill

    label = f"(l) -P {os.path.relpath(PAR_FILE, ROOT)} RF00005_0.fa"
    seq = fa[0].seq
    plain = mccaskill.batch_bp_posteriors_fast([seq], 0.0, dev)[0]
    try:
        res, wall, counts = timed_run(fa, dev, **cli_options(flags))
        report_run(label, res, wall, counts, fa, by_path)
        print(f"(l) overrides in force: {energy_params.PARAM_OVERRIDES}")
        changed = mccaskill.batch_bp_posteriors_fast([seq], 0.0, dev)[0]
    finally:
        energy_params.set_param_overrides({})
    against_snapshot(label, res, ref_name)
    moved = float(np.abs(changed.astype(np.float64) - plain).max())
    print(f"(l) {fa[0].name}'s fold posteriors under the overrides: max |change| = "
          f"{moved!r}", flush=True)
    if not moved > 0.0 or energy_params.PARAM_OVERRIDES:
        raise AssertionError("(l): the parameter file did not change the fold, or stayed")
    default, wall, counts = timed_run(fa, dev)
    report_run("(l) default after the reset RF00005_0.fa", default, wall, counts, fa, by_path)
    if str(default) != SLICE_OUTPUT["RF00005_0.fa"]:
        raise AssertionError("(l): after the reset the default output differs from the "
                             "slice phase's")
    print("(l) after the reset the default output equals the slice phase's", flush=True)


def options_phase(dev):
    """Runs (g)-(l) on RF00005 and `-f 0.5 -r 1` on RF00017; returns
    {kernel name: {run label: launches}}."""
    by_path = {name: {} for name in all_kernels()}
    fa = read_fasta("RF00005_0.fa")
    for run, flags, ref_name in OPTION_RUNS:
        if run == "h":
            fourway_on_card(dev, fa)
        if run == "l":
            aux_round_trip(dev, fa, by_path)
            param_file_runs(dev, fa, by_path, flags, ref_name)
            continue
        label = f"({run}) {' '.join(flags)} RF00005_0.fa"
        res, wall, counts = timed_run(fa, dev, **cli_options(flags))
        report_run(label, res, wall, counts, fa, by_path)
        if run == "g":
            check_refinements(label, res)
        against_snapshot(label, res, ref_name)

    fa = read_fasta("RF00017_4.fa")
    label = "-f 0.5 -r 1 RF00017_4.fa"
    res, wall, counts = timed_run(fa, dev, **cli_options(["-f", "0.5", "-r", "1"]))
    report_run(label, res, wall, counts, fa, by_path)
    check_refinements(label, res)
    print(f"{label}: SS_cons {res.ss_cons}", flush=True)
    return by_path


# ------------------------------------------------------------------- mesh --
# Multi-device execution: the fold, all-pairs and PCT stages sharded over a
# work mesh (`dafs_tpu_torch.parallel.mesh`), on one card as two shards of
# it, and across the cards where there are several.  Every sharded stage
# must give the single-device stage's bits.


def family50():
    """The 50-sequence all-pairs family of `bench.py`, from RF00005."""
    from dafs_tpu_torch.fasta import Fasta
    from dafs_tpu_torch.parallel import dryrun

    seqs = dryrun.mutated_family([f.seq for f in read_fasta("RF00005_0.fa")])
    return [Fasta(f"fam{i}", s) for i, s in enumerate(seqs)]


def family_stages(fa, dev, ctx):
    """Runs the fold, all-pairs, similarity, PCT (base pairs, then matches)
    and guide-tree stages of `Dafs.run` on `fa` under the mesh context
    `ctx`, the launch counts set to 0 just before; returns (outputs,
    seconds, launch counts, peak bytes per device)."""
    import torch

    from dafs_tpu_torch import consistency, guide_tree
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.parallel import mesh
    from dafs_tpu_torch.typedefs import CUTOFF

    lens = [len(f.seq) for f in fa]
    out, secs = {}, {}
    with ctx:
        devices = sorted(set(mesh.work_devices(dev)), key=str)
        for d in devices:
            torch.cuda.synchronize(d)  # the card's context exists before its counters reset
            torch.cuda.reset_peak_memory_stats(d)
        for k in all_kernels().values():
            k.launches = 0
        watch_fold()

        def stage(name, fn):
            for d in devices:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            out[name] = fn()
            for d in devices:
                torch.cuda.synchronize(d)
            secs[name] = time.perf_counter() - t0
            return out[name]

        fold = fold_models.RNAfold(True, CUTOFF)
        posts = stage("fold", lambda: fold.batch_bp_posteriors([f.seq for f in fa], dev, th=0.0))
        bp = fold.all_seqs(fa, dev, posts)
        mp = stage("all-pairs", lambda: align_models.ProbCons(0.01).all_pairs(fa, dev))
        sim = stage("similarity", lambda: consistency.similarity_matrix(mp, lens, dev))
        stage("PCT bp", lambda: consistency.relax_basepairing_probability(
            bp, mp, sim, lens, 0.25, dev))
        stage("PCT mp", lambda: consistency.relax_matching_probability(mp, sim, lens, 0.25, dev))
        stage("guide tree", lambda: guide_tree.print_tree(
            guide_tree.build_tree(sim), [f.name for f in fa]))
        counts = {name: k.launches for name, k in all_kernels().items()}
        peak = {str(d): torch.cuda.max_memory_allocated(d) for d in devices}
    check_fold(f"family-50 stages on {len(devices)} device(s)", counts)
    return out, secs, counts, peak


def bits_equal(a, b) -> bool:
    if isinstance(a, str):
        return a == b
    if isinstance(a, list):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.int32), b.view(np.int32))


def family_on_mesh(label, dev, ctx, by_path):
    """m1: family-50's stages on the mesh of `ctx` against one device."""
    from dafs_tpu_torch.parallel import mesh

    fa = family50()
    want, secs1, _, peak1 = family_stages(fa, dev, mesh.force_single_device())
    got, secs, counts, peak = family_stages(fa, dev, ctx)
    for name, n in counts.items():
        by_path[name][label] = n
    print(f"{label}: {len(fa)} sequences, {len(fa) * (len(fa) - 1) // 2} pairs, lengths "
          f"{min(len(f.seq) for f in fa)}-{max(len(f.seq) for f in fa)}", flush=True)
    for name in want:
        same = bits_equal(got[name], want[name])
        print(f"{label} {name}: sharded {secs[name]:.4f}s, single device {secs1[name]:.4f}s, "
              f"bit-equal {same}", flush=True)
        if not same:
            raise AssertionError(f"{label}: stage {name} differs from the single-device run")
    print(f"{label}: launch counts {counts}; peak bytes per device sharded {peak}, "
          f"single device {peak1}", flush=True)
    for name in PAIRHMM:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")


def rf00005_on_mesh(label, dev, ctx, by_path):
    """m3: RF00005's default path through `align_and_fold` on the mesh:
    tree topology, SS_cons and rows equal the TPU snapshot, the bytes the
    slice phase's."""
    fa = read_fasta("RF00005_0.fa")
    with ctx:
        res, wall, counts = timed_run(fa, dev)
    report_run(label, res, wall, counts, fa, by_path)
    snap, snap_ss, snap_names, snap_rows = read_snapshot("rf00005_default_tpu.txt")
    if (NUM.sub("#", res.tree) != NUM.sub("#", snap) or res.names != snap_names
            or res.ss_cons != snap_ss or res.rows != snap_rows):
        raise AssertionError(f"{label}: differs from the TPU snapshot:\n{res}")
    if str(res) != SLICE_OUTPUT["RF00005_0.fa"]:
        raise AssertionError(f"{label}: differs from the slice phase's single-device bytes")
    print(f"{label}: equals the TPU snapshot (tree topology, SS_cons, rows) and the slice "
          f"phase's bytes", flush=True)


def multiproc_run(label, nprocs, one_card):
    """m4: `parallel.multiproc` with `nprocs` processes on the visible
    cards, or all on the first where `one_card`; all three bitwise_equal
    flags must be true.  Returns its report."""
    env = dict(os.environ)
    if one_card:
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        env["CUDA_VISIBLE_DEVICES"] = first
    proc = subprocess.run(
        [sys.executable, "-m", "dafs_tpu_torch.parallel.multiproc", "--nprocs", str(nprocs),
         "--device", "cuda", "--timeout", "240"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1]) if lines else {}
    print(f"{label}: {json.dumps(report)}", flush=True)
    if proc.returncode != 0 or not report.get("ok") or not all(
            report.get(k) for k in ("bitwise_equal_pairhmm", "bitwise_equal_pct_mp",
                                    "bitwise_equal_pct_bp")):
        raise AssertionError(f"{label}: failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return report


def mesh_phase(dev):
    """m1-m5; returns {kernel name: {run label: launches}}."""
    import torch

    from dafs_tpu_torch.parallel import dryrun, mesh

    by_path = {name: {} for name in all_kernels()}
    one_card = torch.device("cuda", 0)
    family_on_mesh("(m1) family-50, 2 shards of one card", one_card, mesh.virtual_mesh(2),
                   by_path)

    for k in all_kernels().values():
        k.launches = 0
    watch_fold()
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(2, one_card)
    counts = {name: k.launches for name, k in all_kernels().items()}
    check_fold("(m2) dry run", counts)
    for name, n in counts.items():
        by_path[name]["(m2) dry run, 2 shards of one card"] = n
    print(f"(m2) dryrun_multichip(2): {time.perf_counter() - t0:.3f}s for three "
          f"configurations, each twice; launch counts {counts}", flush=True)

    rf00005_on_mesh("(m3) RF00005, 2 shards of one card", one_card, mesh.virtual_mesh(2),
                    by_path)
    report = multiproc_run("(m4) multiproc, 2 processes sharing one card", 2, one_card=True)
    if report.get("collectives") != "gloo":
        raise AssertionError("(m4): two ranks on one card must use gloo")

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"(m5) cross-card form did not run: {cards} card visible (it needs two or more)",
              flush=True)
        return by_path
    print(f"(m5) across {cards} cards: {[torch.cuda.get_device_name(k) for k in range(cards)]}",
          flush=True)
    family_on_mesh(f"(m5) family-50, {cards} cards", dev, mesh.virtual_mesh(cards), by_path)
    rf00005_on_mesh(f"(m5) RF00005, {cards} cards", dev, mesh.virtual_mesh(cards), by_path)
    report = multiproc_run(f"(m5) multiproc, {cards} processes, a card each", cards,
                           one_card=False)
    if report.get("collectives") != "nccl":
        raise AssertionError("(m5): ranks with cards of their own must use NCCL")
    return by_path


def main() -> int:
    import torch

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
    rows, seconds = {}, {}

    def run(phase, fn):
        t = time.perf_counter()
        out = fn(dev)
        seconds[phase] = round(time.perf_counter() - t, 1)
        print(f"phase {phase}: {seconds[phase]}s", flush=True)
        return out

    alone = {"kernels": kernel_phase, "length": length_phase, "fold": fold_phase,
             "dd_step": dd_step_phase, "paircrf": paircrf_phase}
    if sys.argv[1:]:
        for phase in sys.argv[1:]:
            rows.update(run(phase, alone[phase]))
        print(json.dumps({"kernels": list(rows.values())}))
        print(json.dumps({"ok": True, "phases": sys.argv[1:]}))
        return 0
    rows.update(run("kernels", kernel_phase))
    rows.update(run("length", length_phase))
    rows.update(run("fold", fold_phase))
    rows.update(run("dd_step", dd_step_phase))
    rows.update(run("paircrf", paircrf_phase))
    counts = run("slice", slice_phase)
    ali_rows, by_path = run("consensus", consensus_phase)
    rows.update(ali_rows)
    for name, runs in run("paths", paths_phase).items():
        by_path[name].update(runs)
    for name, runs in run("solvers", solvers_phase).items():
        by_path[name].update(runs)
    for name, runs in run("options", options_phase).items():
        by_path[name].update(runs)
    for name, runs in run("mesh", mesh_phase).items():
        by_path[name].update(runs)
    for name, row in rows.items():
        row["launches"] = counts[name]
        row["launches_by_path"] = by_path[name]
    print(f"phase seconds: {seconds}")
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
