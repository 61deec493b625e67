#!/usr/bin/env python3
"""Multi-device runs of the PyTorch port on the card(s).

    python3 tools/torch_mesh.py             # chip_smoke.py's mesh phase alone
    python3 tools/torch_mesh.py --pipeline [--shards 2]

Without options: builds the kernels, runs RF00005's default path on one
device (the bytes the mesh phase holds its sharded run to), then
`chip_smoke.mesh_phase`: (m1) family-50's stages on two shards of one card
against one device, (m2) the dry run, (m3) RF00005 on two shards, (m4) two
processes sharing a card, and where two or more cards are visible (m5) the
same across all of them (m4 under NCCL).

`--pipeline`: the whole default pipeline (`align_and_fold(...,
device="cuda")`, 49 merges through the eager consensus) on the 50-sequence
family of `bench.py`, on a work mesh of `--shards` shards (of one card, or
the first cards where that many are visible); prints the wall, the phase
split, the consensus calls and the DD merges, and the peak bytes of each
card.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def pipeline(shards: int) -> None:
    import torch

    from dafs_tpu_torch.parallel import mesh

    fa = chip_smoke.family50()
    dev = torch.device("cuda")
    with mesh.virtual_mesh(shards):
        cards = sorted({str(d) for d in mesh.work_devices(dev)})
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)  # the card's context exists before its counters reset
            torch.cuda.reset_peak_memory_stats(k)
        res, wall, counts = chip_smoke.timed_run(fa, dev)
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in res.phase_seconds.items())
    iters = sum(t for t, _ in res.device_dd)
    capped = sum(t >= chip_smoke.T_MAX for t, _ in res.device_dd)
    print(f"family-50 pipeline on {shards} shards ({', '.join(cards)}): {wall:.3f}s wall; "
          f"{phases}", flush=True)
    print(f"family-50: device DD {iters} iterations over {len(res.device_dd)} merges "
          f"({capped} at the {chip_smoke.T_MAX} cap); launch counts {counts}", flush=True)
    chip_smoke.consensus_summary("family-50", res.consensus_calls)
    print(f"family-50: peak bytes per card "
          f"{[torch.cuda.max_memory_allocated(k) for k in range(torch.cuda.device_count())]}")
    chip_smoke.check_rows(res, fa)
    chip_smoke.check_balanced("family-50", res.ss_cons)
    print(f"family-50: SS_cons {res.ss_cons}", flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description="multi-device runs of the port")
    ap.add_argument("--pipeline", action="store_true",
                    help="time the whole family-50 pipeline on the mesh")
    ap.add_argument("--shards", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh: torch.cuda.is_available() is false")
    from dafs_tpu_torch import align_and_fold
    from dafs_tpu_torch.ops import cuda_lib

    print(chip_smoke.smi_line(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"built and loaded {cuda_lib.build()} in {time.perf_counter() - t0:.1f}s", flush=True)
    if args.pipeline:
        pipeline(args.shards)
        return 0
    fa = chip_smoke.read_fasta("RF00005_0.fa")
    chip_smoke.SLICE_OUTPUT["RF00005_0.fa"] = str(align_and_fold(fa, device="cuda"))
    t0 = time.perf_counter()
    chip_smoke.mesh_phase(torch.device("cuda"))
    print(f"phase mesh: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
