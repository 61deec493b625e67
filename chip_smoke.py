#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dafs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's `nvidia-smi` name and power limit; fails without CUDA.
2. Builds the CUDA kernels from `dafs_tpu_torch/csrc/` (nvcc, sm_90a).
3. Kernel phase: runs each kernel (K1 pair-HMM forward, K2 backward, K3
   Nussinov, K4 NW) on the card at the shapes of the main path and holds it
   against its plain PyTorch version on the same inputs; the decoders must
   be bit-equal, the pair-HMM passes bit-equal or within 1e-6.  Times both
   with CUDA events.
4. Slice phase: resets the launch counts, runs `align_and_fold(...,
   device="cuda")` on RF00005 (10 tRNAs) and RF00017 (10 SRP RNAs) from
   `tests/data/`, and checks that every kernel was launched, that every
   output row is its input sequence with gaps, and that each guide-tree
   topology equals the TPU snapshot's (`tests/snapshots/*_default_tpu.txt`
   line 1; the tree does not depend on the consensus mix, which this slice
   leaves out).  Reports the largest tree-score difference and the RF00017
   similarity matrix against the recorded one.
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


def nussinov_inputs(rng, B, L, dev):
    import torch

    lens = rng.integers(L - 40, L + 1, size=B).astype(np.int32)
    sm = np.full((B, L, L), np.float32(-0.8), np.float32)
    for b in range(B):
        n = int(lens[b])
        p = np.zeros((n, n), np.float32)
        for _ in range(int(rng.integers(n, 3 * n))):
            i = int(rng.integers(0, n - 3))
            j = int(rng.integers(i + 3, n))
            p[i, j] = rng.random()
        q = (rng.random((n, n)) * 0.2).astype(np.float32)
        sm[b, :n, :n] = np.float32(np.float32(4.0) * (p - np.float32(0.2)) - q)
    return torch.from_numpy(sm).to(dev), torch.from_numpy(lens).to(dev)


def nw_inputs(rng, B, L, dev):
    import torch

    from dafs_tpu_torch.ops import nw

    th = np.float32(0.01)
    sm = np.full((B, L, L), -th, np.float32)
    envf = np.zeros((B, L + 1), np.int32)
    envl = np.full((B, L + 1), L, np.int32)
    l1 = rng.integers(L - 30, L + 1, size=B).astype(np.int32)
    l2 = rng.integers(L - 30, L + 1, size=B).astype(np.int32)
    for b in range(B):
        n1, n2 = int(l1[b]), int(l2[b])
        p = np.zeros((n1, n2), np.float32)
        for i in range(n1):
            j = int(np.clip(round(i * n2 / n1 + rng.integers(-3, 4)), 0, n2 - 1))
            p[i, j] = 0.3 + 0.7 * rng.random()
            if rng.random() < 0.3:
                p[i, int(rng.integers(0, n2))] += 0.2
        env = nw.envelope(p, th)
        q = (rng.random((n1, n2)) * 0.1).astype(np.float32)
        sm[b, :n1, :n2] = np.float32(p - th + q)
        envf[b, : n1 + 1] = env[:, 0]
        envl[b, : n1 + 1] = env[:, 1]
    return [torch.from_numpy(a).to(dev) for a in (sm, envf, envl, l1, l2)]


def max_abs(a, b) -> float:
    import torch

    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def kernel_phase(dev):
    """Returns {kernel name: row of the JSON table}; raises on a mismatch."""
    import torch

    from dafs_tpu_torch.ops import nussinov, nussinov_cuda, nw, nw_cuda
    from dafs_tpu_torch.ops import pairhmm, pairhmm_cuda

    rng = np.random.default_rng(0)
    tab = pairhmm.tables(dev)
    rows = {}

    def record(name, route, source, replaces, err, ms, plain_ms):
        rows[name] = dict(name=name, route=route, source=source,
                          replaces=replaces, launches=0, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms)

    for label, fa_name in (("L<=96", "RF00005_0.fa"), ("L<=320", "RF00017_4.fa")):
        args = pairhmm_inputs(read_fasta(fa_name), dev)
        for name, kfn, pfn, replaces, tol in (
            ("pairhmm_forward", pairhmm_cuda.forward, pairhmm.forward_plain,
             "dafs_tpu/ops/pairhmm_pallas.py:124", 1e-6),
            ("pairhmm_backward", pairhmm_cuda.backward, pairhmm.backward_plain,
             "dafs_tpu/ops/pairhmm_pallas.py:236", 1e-6),
        ):
            got = kfn(*args, tab)
            want = pfn(*args, tab)
            torch.cuda.synchronize()
            err = max(max_abs(g, w) for g, w in zip(got, want))
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = cuda_ms(lambda: kfn(*args, tab), 5)
            plain_ms = cuda_ms(lambda: pfn(*args, tab), 1)
            print(f"kernel {name} B={args[0].shape[0]} {label}: bit-equal={exact} "
                  f"max_abs_err={err!r} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if err > tol:
                raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")
            record(name, "cuda", "dafs_tpu_torch/csrc/pairhmm.cu", replaces,
                   err, ms, plain_ms)

    for L in (96, 352):
        sm, lens = nussinov_inputs(rng, 8, L, dev)
        got = nussinov_cuda.decode(sm, lens)
        want = nussinov.decode_plain(sm, lens)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_abs(g, w) for g, w in zip(got, want))
        ms = cuda_ms(lambda: nussinov_cuda.decode(sm, lens), 10)
        plain_ms = cuda_ms(lambda: nussinov.decode_plain(sm, lens), 1)
        print(f"kernel nussinov B=8 L={L}: bit-equal={exact} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}")
        if not exact:
            raise AssertionError(f"nussinov L={L}: kernel differs from plain version")
        record("nussinov", "cuda", "dafs_tpu_torch/csrc/nussinov.cu",
               "dafs_tpu/ops/nussinov_pallas.py:76", err, ms, plain_ms)

    for L in (96, 320):
        args = nw_inputs(rng, 4, L, dev)
        got = nw_cuda.decode(*args)
        want = nw.decode_plain(*args)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_abs(g, w) for g, w in zip(got, want))
        ms = cuda_ms(lambda: nw_cuda.decode(*args), 10)
        plain_ms = cuda_ms(lambda: nw.decode_plain(*args), 1)
        print(f"kernel nw B=4 L={L}: bit-equal={exact} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}")
        if not exact:
            raise AssertionError(f"nw L={L}: kernel differs from plain version")
        record("nw", "cuda", "dafs_tpu_torch/csrc/nw.cu",
               "dafs_tpu/ops/nw_pallas.py:37", err, ms, plain_ms)
    return rows


# ------------------------------------------------------------------ slice --


def kernels():
    from dafs_tpu_torch.ops import nussinov_cuda, nw_cuda, pairhmm_cuda

    return {
        "pairhmm_forward": pairhmm_cuda.FORWARD,
        "pairhmm_backward": pairhmm_cuda.BACKWARD,
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


def slice_phase(dev):
    """Returns the launch count of every kernel over both runs."""
    import torch

    from dafs_tpu_torch import align_and_fold

    for k in kernels().values():
        k.launches = 0
    for fa_name, snap_name in (("RF00005_0.fa", "rf00005_default_tpu.txt"),
                               ("RF00017_4.fa", "rf00017_default_tpu.txt")):
        fa = read_fasta(fa_name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = align_and_fold(fa, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
        print(f"slice {fa_name}: {wall:.3f}s wall; {phases}")
        check_rows(res, fa)
        with open(os.path.join(SNAP, snap_name)) as fh:
            snap = fh.readline().strip()
        if NUM.sub("#", res.tree) != NUM.sub("#", snap):
            raise AssertionError(f"{fa_name} tree topology differs:\n{res.tree}\n{snap}")
        digits = max(abs(float(a) - float(b)) for a, b in
                     zip(NUM.findall(res.tree), NUM.findall(snap)))
        print(f"{fa_name} tree topology equals the TPU snapshot; largest score "
              f"difference {digits!r}; SS_cons {res.ss_cons}")
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
