#!/usr/bin/env python3
"""What the fold kernels' granularity costs (`dafs_tpu_torch/csrc/mccaskill.cu`),
on one NVIDIA GPU.

    python3 tools/fold_variants.py [--reps 5] [--rounds 2]

Builds copies of `csrc/mccaskill.cu` (with `common.cuh` pasted in) with the
library's nvcc flags into `build/fold_variants/`:

- `tree`: the source as it is: a warp a cell, as many CTAs as fit.
- `a CTA a cell`: `kCellThreads` 256, the consensus kernels'
  granularity: the 256 threads of a CTA share a cell's stencil slots and
  row sums, summed by warp shuffles and then across the warps.
- `one CTA an SM`: a warp a cell, the grid capped at the SM count (a
  quarter to an eighth of the cells in flight).

Each variant's inside and outside are timed against the tree's, in turns,
`--rounds` times, on the same inputs (CUDA-event means over `--reps`
launches after a warm-up launch): the buckets of RF00005 (10 tRNAs, L 96),
RF00017 (10 SRP RNAs, L 320) and bench.py's fifty mutated RF00005 tRNAs (L
96), each at the scale its pf-scale ladder takes; each variant's pout and Q
are held to the tree's at rtol 2e-4 (atol 1e-6 on pout).  Writes
`chiprun_out/fold_variants.json`.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ERROR_STRING = """
extern "C" const char* dafs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""
# a CTA a cell: the warps' butterfly sums, then the warps' sums in warp
# order, the same bits in every thread of the CTA
CTA_SUM = """__device__ __forceinline__ float cell_sum(float x) {
  __shared__ float red[kThreads / 32];
  x = warp_sum(x);
  __syncthreads();   // an earlier sum has been read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}"""
VARIANTS = {
    "tree": [],
    "a CTA a cell": [
        ("constexpr int kCellThreads = 32;", "constexpr int kCellThreads = kThreads;"),
        ("__device__ __forceinline__ float cell_sum(float x) { return warp_sum(x); }", CTA_SUM)],
    "one CTA an SM": [("const int fit = per_sm * sms;", "const int fit = sms;")],
}


def build(out_dir):
    """{variant: path of its library}, built in parallel."""
    from dafs_tpu_torch.ops import cuda_lib

    csrc = cuda_lib.CSRC_DIR
    text = open(os.path.join(csrc, "mccaskill.cu")).read().replace(
        '#include "common.cuh"',
        open(os.path.join(csrc, "common.cuh")).read().replace("#pragma once\n", ""))
    procs = {}
    for name, subs in VARIANTS.items():
        patched = text
        for old, new in subs:
            if old not in patched:
                raise RuntimeError(f"mccaskill.cu {name}: the source no longer has {old!r}")
            patched = patched.replace(old, new)
        stem = "mccaskill_" + name.replace(" ", "_")
        cu = os.path.join(out_dir, stem + ".cu")
        with open(cu, "w") as fh:
            fh.write(patched + ERROR_STRING)
        so = os.path.join(out_dir, stem + ".so")
        procs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", csrc, "-o", so, cu]))
    for name, (_, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed")
    return {name: so for name, (so, _) in procs.items()}


def buckets():
    """{label: sequences} of the three buckets."""
    import chip_smoke as cs

    return {"RF00005 (10, L 96)": [f.seq for f in cs.read_fasta("RF00005_0.fa")],
            "RF00017 (10, L 320)": [f.seq for f in cs.read_fasta("RF00017_4.fa")],
            "family-50 (50, L 96)": [f.seq for f in cs.family50()]}


def main() -> int:
    import torch

    import chip_smoke as cs
    from dafs_tpu_torch.ops import cuda_lib, mccaskill_cuda

    if not torch.cuda.is_available():
        raise SystemExit("fold_variants: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = cs.smi_line()
    print(smi, flush=True)
    out_dir = os.path.join(ROOT, "build", "fold_variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: ctypes.CDLL(so) for name, so in build(out_dir).items()}
    dev = torch.device("cuda")

    def use(name):
        for attr in ("INSIDE", "EXTERIOR", "OUTSIDE"):
            sym = getattr(mccaskill_cuda, attr).symbol
            setattr(mccaskill_cuda, attr, cuda_lib.CudaKernel(sym, [ctypes.c_void_p],
                                                              loader=lambda: libs[name]))

    inputs = {}
    for label, seqs in buckets().items():
        _, _, last = cs.traced_fold(seqs, dev, True, None, None, plain=False)
        pk = mccaskill_cuda.pack(last["prep"], last["sc"])
        inputs[label] = (pk, mccaskill_cuda.launch_args(pk))
    report = dict(card=smi, times={}, agree={})
    want = {}
    for _ in range(args.rounds):
        for name in VARIANTS:
            use(name)
            for label, (pk, la) in inputs.items():
                mccaskill_cuda.inside(pk, la)
                mccaskill_cuda.exterior(pk, la)
                mccaskill_cuda.outside(pk, la)
                got = (pk["tensors"]["pout"].clone(), pk["tensors"]["q"].clone())
                want.setdefault(label, got)
                ok = (cs.consensus_agree(got[0], want[label][0], "pout")
                      and cs.consensus_agree(got[1], want[label][1], "Q"))
                report["agree"][f"{name} | {label}"] = ok
                if not ok:
                    raise AssertionError(f"{name} {label}: pout or Q differs from the tree's")
                for scan in ("inside", "outside"):
                    fn = getattr(mccaskill_cuda, scan)
                    ms = cs.cuda_ms(lambda: fn(pk, la), args.reps)
                    report["times"].setdefault(f"{name} | {label} | {scan}", []).append(ms)
                    print(f"{name} {label} {scan}: {ms:.4f} ms", flush=True)
    for key, v in report["times"].items():
        name, label, scan = key.split(" | ")
        tree = np.mean(report["times"][f"tree | {label} | {scan}"])
        print(f"{name:>14} {label:>22} {scan:>7}: {np.mean(v):.4f} ms "
              f"({np.mean(v) / tree:.3f} of the tree's)")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fold_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
