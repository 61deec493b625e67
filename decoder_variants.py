#!/usr/bin/env python3
"""Time design alternatives of the CUDA kernels K1/K2 (pair-HMM), K3
(Nussinov) and K4 (NW) against the kernels in the tree, on one NVIDIA GPU.

    python3 decoder_variants.py [--reps 20] [--rounds 2] [--only pairhmm]

Each variant is a copy of a source under `dafs_tpu_torch/csrc/` (with
`common.cuh` pasted in, so that a change may touch either) with one change,
built with the library's nvcc flags into `build/variants/`:

- K3 `global tables`: the dp and pair tables in global memory (L2) at every
  width, the layout the tree keeps for widths whose tables do not fit in
  the cluster's shared memory.  Must equal the plain version.
- K3 `no barrier`, `no split loop`, `no walk`; K4 `no copies`,
  `no code stores`, `no walk`: one part of the kernel left out.  Their
  results are wrong; the time they save is what that part costs.
- K4 `4-byte copies`: the score ring filled 4 bytes a copy.  Must equal the
  plain version.
- K1/K2 (`pairhmm.cu`): `no global stores`, `no barrier` (a warp takes
  whatever its neighbour's slot holds), `constant emissions` (results
  wrong), and must-equal changes of LOG_ADD: `table LOOKUP`
  (the piece's coefficients as one 16-byte read of a table in constant
  memory, not twelve selects) and `LOG_ZERO test` (the reference's
  `lo == LOG_ZERO` compare kept).
  Both passes are timed at B=45 for L<=96 and L<=320 (RF00005's and RF00017's
  all-pairs batches).

Variants and the tree's kernel run in turns, `--rounds` times, on the same
inputs (CUDA-event means over `--reps` launches, after a warm-up launch).
Prints one line per measurement and writes them to
`chiprun_out/decoder_variants.json`.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

K3_LOOP_SYNC = """    if (C == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  }"""
TABLE_LOOKUP = """__constant__ float4 kLookupPieces[4] = {
    {-0x1.32687ap-7f, 0x1.0b9738p-3f, 0x1.fec56p-2f, 0x1.62eb84p-1f},
    {-0x1.dc31f4p-7f, 0x1.1e9a14p-3f, 0x1.fb87ep-2f, 0x1.62604p-1f},
    {-0x1.2dcb9cp-8f, 0x1.03cc78p-4f, 0x1.645468p-1f, 0x1.074ebep-1f},
    {-0x1.e0f10ap-12f, 0x1.3db77ep-7f, 0x1.dc8942p-1f, 0x1.5823dep-3f}};
__device__ __forceinline__ float dafs_lookup(float x) {
  const float4 p = kLookupPieces[(x > 1.0f) + (x > 2.5f) + (x > 4.5f)];
  return ((p.x * x + p.y) * x + p.z) * x + p.w;
}
__device__ __forceinline__ float dafs_lookup_selects(float x) {"""
VARIANTS = {
    "pairhmm.cu": {
        "tree": ([], True),
        "no global stores": ([("      out[i * W + j] = M1;\n", "      ;\n")], False),
        "no barrier": ([('  if (nlive > 1) asm volatile("bar.sync 1, %0;\\n" :: "r"(32 * nlive) : "memory");\n', "")], False),
        "constant emissions": ([("m_d = T->match[c17 + cj];", "m_d = T->match[8];"),
                                ("e2 = T->ins[cj];", "e2 = T->ins[1];"),
                                ("T->match[c17n + cjn]", "T->match[8]"),
                                ("ins2_n = T->ins[cjn];", "ins2_n = T->ins[1];")], False),
        "table LOOKUP": ([("__device__ __forceinline__ float dafs_lookup(float x) {", TABLE_LOOKUP)], True),
        "LOG_ZERO test": ([("  return d >= DAFS_LOG_UNDERFLOW ? hi : approx;",
                           "  return (lo == DAFS_LOG_ZERO || d >= DAFS_LOG_UNDERFLOW) ? hi : approx;")], True),
    },
    "nussinov.cu": {
        "tree": ([], True),
        "global tables": ([("const bool smem_tables = stack_bytes(L) + tables <= DAFS_SMEM_MAX;",
                            "const bool smem_tables = false;")], True),
        "no barrier": ([(K3_LOOP_SYNC, "  }\n  cluster.sync();")], False),
        "no split loop": ([("o <= s; o += G", "o <= 0; o += G")], False),
        "no walk": ([("  while (true) {", "  while (l < 0) {")], False),
    },
    "nw.cu": {
        "tree": ([], True),
        "4-byte copies": ([("const bool vec = L2 % 4 == 0 &&", "const bool vec = false &&")], True),
        "no copies": ([("const bool ok = row && lane * CH + 4 * q < L2;", "const bool ok = false;")], False),
        "no code stores": ([("    store_codes<CH>(tr + i * RW, code, lane);\n", "")], False),
        "no walk": ([("  while (i > 0 && k > 0) {", "  while (l1 < 0) {")], False),
    },
}


def build(out_dir, only=None):
    """Compile every variant in parallel; returns {(source, name): path}."""
    from dafs_tpu_torch.ops import cuda_lib

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for src, variants in VARIANTS.items():
        if only and only not in src:
            continue
        text = open(os.path.join(cuda_lib.CSRC_DIR, src)).read().replace(
            '#include "common.cuh"',
            open(os.path.join(cuda_lib.CSRC_DIR, "common.cuh")).read().replace("#pragma once\n", ""))
        for name, (subs, _) in variants.items():
            patched = text
            for old, new in subs:
                if old not in patched:
                    raise RuntimeError(f"{src} {name}: the source no longer has {old!r}")
                patched = patched.replace(old, new)
            stem = f"{os.path.basename(src)[:-3]}_{name.replace(' ', '_').replace('-', '_')}"
            cu = os.path.join(out_dir, stem + ".cu")
            with open(cu, "w") as fh:
                fh.write(patched)
            so = os.path.join(out_dir, stem + ".so")
            procs[(src, name)] = (so, subprocess.Popen(
                [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-diag-suppress", "177", "-I", cuda_lib.CSRC_DIR,
                 "-o", so, cu]))
    for key, (_, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{key}: nvcc failed")
    return {key: so for key, (so, _) in procs.items()}


def main() -> int:
    import torch

    import chip_smoke as cs
    from dafs_tpu_torch.ops import cuda_lib, nussinov, nussinov_cuda, nw, pairhmm, pairhmm_cuda

    if not torch.cuda.is_available():
        raise SystemExit("decoder_variants: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default=None, help="sources whose path holds this text")
    args = ap.parse_args()
    smi = cs.smi_line()
    print(smi, flush=True)
    libs = build(os.path.join(ROOT, "build", "variants"), args.only)
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    P, I = ctypes.c_void_p, ctypes.c_int
    p = cuda_lib.ptr
    rng = np.random.default_rng(7)
    k3_cases = [(B, L, cs.nussinov_inputs(rng, B, L, dev))
                for B, L in ((8, 352), (8, 384), (10, 352), (8, 96), (1, 384))]
    k4_cases = [(B, L1, L2, cs.nw_inputs(rng, B, L1, L2, dev))
                for B, L1, L2 in ((4, 320, 320), (4, 352, 320), (5, 352, 320), (4, 96, 96))]

    def k3_run(fn, B, L, sm, lens):
        dp = torch.empty((B, L, L), device=dev)
        mt = torch.empty_like(dp)
        code = torch.empty((B, L * (L - 1) // 2), dtype=torch.int16, device=dev)
        score = torch.empty(B, device=dev)
        ss = torch.empty((B, L), dtype=torch.int32, device=dev)
        C = nussinov_cuda.cluster_size(B, L)

        def run():
            if fn(p(sm), p(lens), p(dp), p(mt), p(code), p(score), p(ss), B, L, C, stream):
                raise RuntimeError("launch failed")
        return run, (score, ss)

    def k4_run(fn, B, L1, L2, inputs):
        score = torch.empty(B, device=dev)
        al = torch.empty((B, L1), dtype=torch.int32, device=dev)

        def run():
            if fn(*(p(a) for a in inputs), p(score), p(al), B, L1, L2, stream):
                raise RuntimeError("launch failed")
        return run, (score, al)

    tab = pairhmm.tables(dev)
    tabs = pairhmm_cuda.table_ptrs(tab, tab["match"].device)
    k12_cases = [(label, cs.pairhmm_inputs(cs.read_fasta(fa), dev))
                 for label, fa in (("B=45 L<=96", "RF00005_0.fa"), ("B=45 L<=320", "RF00017_4.fa"))]
    k12_plain = {}

    def k12_runs(lib):
        """(shape, run, outputs, plain) for both passes of a pair-HMM
        variant; the plain versions are computed once a shape."""
        out = []
        for label, inp in k12_cases:
            B, imax = inp[0].shape
            W = inp[2].shape[1]
            for sym, ncap, plain in (("dafs_pairhmm_forward", 6, pairhmm.forward_plain),
                                     ("dafs_pairhmm_backward", 3, pairhmm.backward_plain)):
                fn = getattr(lib, sym)
                plane = torch.empty((B, imax, W), device=dev)
                cap = torch.empty((B, ncap), device=dev)
                fn.argtypes = [P] * 10 + [I] * 3 + [P]

                def run(fn=fn, inp=inp, plane=plane, cap=cap, B=B, imax=imax, W=W):
                    if fn(*(p(a) for a in inp), *tabs, p(plane), p(cap), B, imax, W - 1, stream):
                        raise RuntimeError("launch failed")

                def want(label=label, sym=sym, plain=plain, inp=inp):
                    if (label, sym) not in k12_plain:
                        k12_plain[label, sym] = plain(*inp, tab)
                    return k12_plain[label, sym]
                out.append((f"{sym[13:]} {label}", run, (plane, cap), want))
        return out

    results = []
    keys = list(libs)
    for rnd in range(args.rounds):
        # the tree's kernel and the variants in turns, the order reversed
        # every other round
        for src, name in (keys if rnd % 2 == 0 else keys[::-1]):
            so = libs[(src, name)]
            must_equal = VARIANTS[src][name][1]
            lib = ctypes.CDLL(so)
            if src == "pairhmm.cu":
                cases = k12_runs(lib)
            elif src == "nussinov.cu":
                fn = lib.dafs_nussinov_decode
                fn.argtypes = [P] * 7 + [I] * 3 + [P]
                cases = [(f"B={B} L={L}", *k3_run(fn, B, L, *inp), lambda inp=inp: nussinov.decode_plain(*inp))
                         for B, L, inp in k3_cases]
            else:
                fn = lib.dafs_nw_decode
                fn.argtypes = [P] * 7 + [I] * 3 + [P]
                cases = [(f"B={B} {L1}x{L2}", *k4_run(fn, B, L1, L2, inp), lambda inp=inp: nw.decode_plain(*inp))
                         for B, L1, L2, inp in k4_cases]
            for shape, run, out, plain in cases:
                if rnd == 0:
                    for o in out:  # so that a part left out cannot pass for equal
                        o.fill_(-1)
                run()
                equal = cs.same(out, plain())[0] if rnd == 0 else None
                if must_equal and equal is False:
                    raise AssertionError(f"{src} {name} {shape}: differs from the plain version")
                ms = cs.cuda_ms(run, args.reps)
                results.append(dict(source=src, variant=name, shape=shape, round=rnd, ms=ms,
                                    equal=equal))
                print(f"round {rnd} {src} {name!r} {shape}: {ms:.4f} ms"
                      + ("" if equal is None else f" equal={equal}"), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "decoder_variants.json"), "w") as fh:
        json.dump({"card": smi, "reps": args.reps, "results": results}, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
