#!/usr/bin/env python3
"""Where the consensus kernels' time goes (`dafs_tpu_torch/csrc/alifold.cu`),
and what some of their design choices cost, on one NVIDIA GPU.

    python3 tools/consensus_variants.py [--reps 5] [--rounds 2]

Builds copies of `csrc/alifold.cu` (with `common.cuh` pasted in) with the
library's nvcc flags into `build/variants/`:

- `tree`: the source as it is.
- `traced`: the source with timestamps (`%globaltimer`, ns) taken by thread
  0 of CTA 0 in the inside scan: at a diagonal's start, at its first
  pair-allowed cell's entry, after that cell's first loads and staging,
  after its active stencil cells are listed, after the product over the
  sequences, after the block sum, after the stores, after the diagonal's
  other cells; and in the product, at its start, when the first group's
  records have arrived and when that group's factors are multiplied.
- `no B group`: the B group's table lookups left out.  Its results are
  wrong; the time it saves is what the B group costs.
- `two CTAs an SM`: `__launch_bounds__(256, 2)` (registers capped at 128,
  the grid twice as large).
- `groups of 8`: the records of 8 sequences loaded at once, not 10.

Each variant's inside and outside are timed against the tree's, in turns,
`--rounds` times, on the same inputs (CUDA-event means over `--reps`
launches after a warm-up launch): RF00005's and RF00017's TPU outputs and
bench.py's fifty mutated RF00005 tRNAs cut to 69 columns, each at the scale
its pf-scale ladder takes.  Then the traced inside's mean phase times over
the diagonals whose first CTA holds a pair-allowed cell.  Writes
`chiprun_out/consensus_variants.json`.  Needs a card; imports nothing of
JAX.
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
TRACE_HEAD = """namespace cg = cooperative_groups;
__device__ unsigned long long* g_trace;
__device__ int g_d;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int dafs_set_trace(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#define STAMP(slot)                                                   \\
  do {                                                                \\
    if (g_trace && blockIdx.x == 0 && threadIdx.x == 0)               \\
      g_trace[g_d * 16 + (slot)] = now_ns();                          \\
  } while (0)
"""
# (text of the source, text that replaces it) for the traced copy; slots:
# 0 diagonal start, 1 cell entry, 2 staged, 3 listed, 4 product, 5 summed,
# 6 stored, 7 other cells done, 8 product start, 9 records in, 10 factors
TRACE = [
    ("namespace cg = cooperative_groups;", TRACE_HEAD),
    ("""  for (int d = 1; d < a.n; ++d) {
    const int beg""", """  for (int d = 1; d < a.n; ++d) {
    if (blockIdx.x == 0 && threadIdx.x == 0) g_d = d;
    STAMP(0);
    const int beg"""),
    ("""  const int64_t cij = ldo(a, i, j);
  Qm1Operands o{};
  float hp = 0.0f""", """  const int64_t cij = ldo(a, i, j);
  STAMP(1);
  Qm1Operands o{};
  float hp = 0.0f"""),
    ("""  stage_chunk<true>(a, sm.st, i, j, cij, 0, min(kChunk, a.ns));
  float mlsum""", """  stage_chunk<true>(a, sm.st, i, j, cij, 0, min(kChunk, a.ns));
  STAMP(2);
  float mlsum"""),
    ("""  const int nact = list_active(sm.act, sl, part);""",
     """  const int nact = list_active(sm.act, sl, part);
  if (kInside) STAMP(3);"""),
    ("""#pragma unroll
  for (int r = 0; r < kCellsPerThread; ++r) {
    const int e = tid + r * kThreads;
    if (e < nact) {
      if (kInside)""", """  if (kInside) STAMP(4);
#pragma unroll
  for (int r = 0; r < kCellsPerThread; ++r) {
    const int e = tid + r * kThreads;
    if (e < nact) {
      if (kInside)"""),
    ("""  block_sum3(interior, mlsum, rest, sm.red);
  if (tid == 0) {""", """  block_sum3(interior, mlsum, rest, sm.red);
  STAMP(5);
  if (tid == 0) {"""),
    ("""    store_qm1_qm(a, o, i, j, qb, rest);
  }
}""", """    store_qm1_qm(a, o, i, j, qb, rest);
  }
  STAMP(6);
}"""),
    ("""      inside_rest(a, i, d);
    }
    grid.sync();""", """      inside_rest(a, i, d);
    }
    STAMP(7);
    grid.sync();"""),
    ("""    float4 x[kGroup];
    int pcs[kGroup];""", """    float4 x[kGroup];
    int pcs[kGroup];
    if (kInside && s1 == 0) STAMP(8);"""),
    ("""        pcs[g] = full && uside ? __ldg(code + s1 + g) : 0;
      }
    }""", """        pcs[g] = full && uside ? __ldg(code + s1 + g) : 0;
      }
    }
    if (kInside && s1 == 0) {
      asm volatile("" : : "f"(x[0].x), "r"(pcs[0]) : "memory");
      STAMP(9);
    }"""),
    ("""      kp = kp * k;
    }
  }
  return kp;""", """      kp = kp * k;
    }
    if (kInside && s1 == 0) {
      asm volatile("" : : "f"(kp) : "memory");
      STAMP(10);
    }
  }
  return kp;"""),
]
VARIANTS = {
    "tree": [],
    "traced": TRACE,
    "no B group": [("if (full && uside && U1 <= 2 && U2 <= 2) {", "if (false) {")],
    "two CTAs an SM": [("__launch_bounds__(kThreads, 1) inside_kernel",
                        "__launch_bounds__(kThreads, 2) inside_kernel"),
                       ("__launch_bounds__(kThreads, 1) outside_kernel",
                        "__launch_bounds__(kThreads, 2) outside_kernel")],
    "groups of 8": [("constexpr int kGroup = 10;", "constexpr int kGroup = 8;")],
}
PHASES = [("start to the cell", 0, 1), ("first loads and staging", 1, 2),
          ("listing the active cells", 2, 3), ("product", 3, 4),
          ("block sum", 4, 5), ("stores", 5, 6), ("the other cells", 6, 7),
          ("barrier", 7, None), ("product: records", 8, 9),
          ("product: first group's factors", 9, 10)]


def build(out_dir):
    """{variant: path of its library}, built in parallel."""
    from dafs_tpu_torch.ops import cuda_lib

    csrc = cuda_lib.CSRC_DIR
    text = open(os.path.join(csrc, "alifold.cu")).read().replace(
        '#include "common.cuh"',
        open(os.path.join(csrc, "common.cuh")).read().replace("#pragma once\n", ""))
    procs = {}
    for name, subs in VARIANTS.items():
        patched = text
        for old, new in subs:
            if old not in patched:
                raise RuntimeError(f"alifold.cu {name}: the source no longer has {old!r}")
            patched = patched.replace(old, new)
        stem = "alifold_" + name.replace(" ", "_")
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


def main() -> int:
    import torch

    import chip_smoke as cs
    from dafs_tpu_torch.ops import alifold, alifold_cuda, cuda_lib
    from dafs_tpu_torch.ops import alifold_kernel as ak
    from tools.torch_consensus_ab import shapes

    if not torch.cuda.is_available():
        raise SystemExit("consensus_variants: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = cs.smi_line()
    print(smi, flush=True)
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: ctypes.CDLL(so) for name, so in build(out_dir).items()}
    dev = torch.device("cuda")

    def use(name):
        for attr, sym in (("INSIDE", "dafs_alifold_inside"), ("OUTSIDE", "dafs_alifold_outside")):
            setattr(alifold_cuda, attr, cuda_lib.CudaKernel(sym, [ctypes.c_void_p],
                                                            loader=lambda: libs[name]))

    inputs = {}
    use("tree")
    for label, seqs in shapes().items():
        x = alifold._inputs(seqs, True, None)
        n = x["n"]
        BCUT = alifold._bcut(x["S"], n)
        dargs = alifold.device_args(x, dev)
        _, _, sc, _ = alifold.partition(dargs, n, x["bsn0"], alifold.SC0, BCUT,
                                        alifold_cuda.call_loops())
        pk = alifold_cuda.pack(ak.prepare(*dargs, n, sc, x["bsn0"]), n, BCUT)
        inputs[label] = (n, pk, alifold_cuda.launch_args(pk))
    report = dict(card=smi, times={}, phases={})
    for _ in range(args.rounds):
        for name in VARIANTS:
            if name == "traced":
                continue
            use(name)
            for label, (n, pk, la) in inputs.items():
                for scan in ("inside", "outside"):
                    fn = getattr(alifold_cuda, scan)
                    ms = cs.cuda_ms(lambda: fn(pk, la), args.reps)
                    report["times"].setdefault(f"{name} | {label} | {scan}", []).append(ms)
                    print(f"{name} {label} {scan}: {ms:.4f} ms", flush=True)
    use("traced")
    lib = libs["traced"]
    for label, (n, pk, la) in inputs.items():
        buf = torch.zeros((n + 1) * 16, dtype=torch.int64, device=dev)
        if lib.dafs_set_trace(ctypes.c_void_p(buf.data_ptr())) != 0:
            raise RuntimeError("dafs_set_trace failed")
        alifold_cuda.inside(pk, la)
        buf.zero_()
        alifold_cuda.inside(pk, la)
        torch.cuda.synchronize()
        lib.dafs_set_trace(ctypes.c_void_p(0))
        t = buf.view(n + 1, 16).cpu().numpy().astype(np.int64)
        off = pk["tensors"]["pair_off"].cpu().numpy()
        held = [d for d in range(1, n - 1) if off[d + 1] > off[d] and t[d, 1] > 0 and t[d, 10] > 0]
        rest = [d for d in range(1, n - 1) if off[d + 1] == off[d]]
        row = {"diagonal, with a pair-allowed cell": float(np.mean([t[d + 1, 0] - t[d, 0]
                                                                    for d in held])),
               "diagonal, without": float(np.mean([t[d + 1, 0] - t[d, 0] for d in rest]))
               if rest else None}
        for phase, a, b in PHASES:
            row[phase] = float(np.mean([(t[d + 1, 0] if b is None else t[d, b]) - t[d, a]
                                        for d in held]))
        report["phases"][label] = row
        print(f"traced inside {label}: {len(held)} of {n - 1} diagonals with a pair-allowed "
              "cell; mean ns: " + ", ".join(f"{k} {v:.0f}" for k, v in row.items()
                                            if v is not None), flush=True)
    for key, v in report["times"].items():
        name, label, scan = key.split(" | ")
        tree = np.mean(report["times"][f"tree | {label} | {scan}"])
        print(f"{name:>15} {label:>24} {scan:>7}: {np.mean(v):.4f} ms "
              f"({np.mean(v) / tree:.3f} of the tree's)")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "consensus_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
