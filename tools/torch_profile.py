#!/usr/bin/env python3
"""Phase split, consensus calls and device idle share of the PyTorch port
on one NVIDIA GPU.

    python3 tools/torch_profile.py [--reps 3] \
        [--runs default:RF00005_0.fa,default:RF00017_4.fa,a:RF00005_0.fa,...]

Each run is a path and a family (from `tests/data/`, or `family-50`:
bench.py's 50 mutated RF00005 tRNAs, `chip_smoke.family50`).  The paths are
`default` (DAFS's default options), `a` (`-s CONTRAfold -a CONTRAlign`) and
`b` (`--bp-update --bp-update1`).  For each run: one untimed warm-up run of
`align_and_fold(..., device="cuda")`, then `--reps` timed runs (host clock,
ended by a synchronise; median and range per phase), then one run under
`torch.profiler` (device activity only: a host-side trace of RF00017's
millions of eager ops takes the profiler longer to process than the run)
for the device busy time (the union of all device activity intervals) and
the device time by kernel name.  The idle share is 1 - busy / wall of that
profiled run, and also against the median wall.  Also reports whether
every run printed the same alignment and structure.  Before any whole run
it traces, for the default path, the align phase alone
(`ProbCons.all_pairs`): every device kernel and copy it runs, on one line,
with the count of those that are not the port's own kernels; and for path
(a) the plain PyTorch fold and align code alone (`CONTRAfold.all_seqs`,
`CONTRAlign.all_pairs`): host seconds, device busy seconds and the number
of device kernels each launches.
Writes the whole report as JSON to `chiprun_out/torch_profile.json` and a
summary to standard output.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_seconds(prof) -> float:
    """Union of the device activity intervals of a profiler run."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6


def device_table(prof, top=12):
    rows = []
    for a in prof.key_averages():
        t = getattr(a, "device_time_total", None)
        if t is None:
            t = a.cuda_time_total
        if t > 0:
            rows.append((a.key, t * 1e-3, a.count))
    rows.sort(key=lambda r: -r[1])
    return [dict(name=k, ms=ms, count=c) for k, ms, c in rows[:top]]


def align_trace(name):
    """Device activity of a family's align phase alone: [{name, ms, count}],
    and how many of the kernels are not hand-written ones of the port.
    Traced before any whole run: a short window opened after a long
    profiler session lost most of its events."""
    import torch

    from dafs_tpu_torch import load_fasta
    from dafs_tpu_torch.models import align_models
    from dafs_tpu_torch.pipeline import Options

    fa = load_fasta(os.path.join(ROOT, "tests", "data", name))
    model = align_models.ProbCons(Options().th_a)
    model.all_pairs(fa, "cuda")  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        model.all_pairs(fa, "cuda")
        torch.cuda.synchronize()
    table = device_table(prof, top=50)
    other = [r for r in table
             if "pairhmm_" not in r["name"] and not r["name"].lower().startswith("memcpy")]
    return table, sum(r["count"] for r in other)


def plain_trace(name):
    """Path (a)'s fold and align models alone, each after a warm-up call:
    {model: {seconds, device_busy, launches}} (launches: device kernels,
    copies and fills not counted)."""
    import torch

    from dafs_tpu_torch import load_fasta
    from dafs_tpu_torch.models import align_models, fold_models
    from dafs_tpu_torch.pipeline import Options
    from dafs_tpu_torch.typedefs import CUTOFF

    fa = load_fasta(os.path.join(ROOT, "tests", "data", name))
    out = {}
    for label, fn in (
        ("CONTRAfold fold", lambda: fold_models.CONTRAfold(CUTOFF).all_seqs(fa, "cuda")),
        ("CONTRAlign pair-CRF align", lambda: align_models.CONTRAlign(Options().th_a).all_pairs(fa, "cuda")),
    ):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        table = device_table(prof, top=10**6)
        launches = sum(r["count"] for r in table
                       if not r["name"].lower().startswith(("memcpy", "memset")))
        out[label] = dict(seconds=sec, device_busy=busy_seconds(prof), launches=launches)
    return out


PATHS = {
    "default": {},
    "a": dict(align_model="CONTRAlign", fold_model="CONTRAfold"),
    "b": dict(use_bp_update=True, use_bp_update1=True),
}


def run_family(path, name, reps):
    import torch

    from dafs_tpu_torch import align_and_fold, load_fasta

    if name == "family-50":
        import chip_smoke

        fa = chip_smoke.family50()
    else:
        fa = load_fasta(os.path.join(ROOT, "tests", "data", name))

    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = align_and_fold(fa, device="cuda", **PATHS[path])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    once()  # warm-up
    runs = [once() for _ in range(reps)]
    walls = [w for w, _ in runs]
    phases = {
        k: [r.phase_seconds[k] for _, r in runs] for k in runs[0][1].phase_seconds
    }
    calls = [c for _, r in runs for c in r.consensus_calls]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall, prof_res = once()
    outputs = {str(r) for _, r in runs} | {str(prof_res)}
    busy = busy_seconds(prof)
    med = statistics.median(walls)
    return dict(
        path=path, family=name, walls=walls, wall_median=med,
        outputs_identical=len(outputs) == 1,
        phases={k: dict(median=statistics.median(v), lo=min(v), hi=max(v))
                for k, v in phases.items()},
        consensus_calls=calls,
        profiled_wall=prof_wall, device_busy=busy,
        idle_share_profiled=1.0 - busy / prof_wall,
        idle_share_median_wall=1.0 - busy / med,
        device_time_by_kernel=device_table(prof),
    )


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--runs", default="default:RF00005_0.fa,default:RF00017_4.fa",
                    help="comma-separated PATH:FAMILY, PATH one of " + ", ".join(PATHS))
    args = ap.parse_args()
    runs = [r.split(":") for r in args.runs.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    report = dict(card=smi, device=torch.cuda.get_device_name(0), families=[])
    traces = {(p, name): align_trace(name) if p == "default" else plain_trace(name)
              for p, name in runs if p in ("default", "a") and name != "family-50"}
    for path, name in runs:
        r = run_family(path, name, args.reps)
        if (path, name) in traces and path == "default":
            r["align_kernels"], r["align_other_kernels"] = traces[path, name]
        elif (path, name) in traces:
            r["plain_models"] = traces[path, name]
        report["families"].append(r)
        print(f"path {path}, {name}: wall median {r['wall_median']:.3f}s "
              f"[{min(r['walls']):.3f}-{max(r['walls']):.3f}] over {args.reps}; "
              f"every run's output identical: {r['outputs_identical']}")
        for k, v in r["phases"].items():
            print(f"  {k}: {v['median']:.4f}s [{v['lo']:.4f}-{v['hi']:.4f}]")
        ali = [c for c in r["consensus_calls"] if c["route"] == "alifold"]
        print(f"  consensus: {len(r['consensus_calls']) // args.reps} calls per run, "
              f"{sum(c['seconds'] for c in r['consensus_calls']) / args.reps:.3f}s per run, "
              f"of it host prep {sum(c['prep_seconds'] for c in ali) / args.reps:.3f}s; "
              f"ladder attempts per run {sum(c['attempts'] for c in ali) / args.reps}")
        print(f"  profiled run {r['profiled_wall']:.3f}s, device busy "
              f"{r['device_busy']:.3f}s, idle share {r['idle_share_profiled']:.3f} "
              f"(against the median wall {r['idle_share_median_wall']:.3f})")
        for row in r["device_time_by_kernel"][:8]:
            print(f"    {row['ms']:10.1f} ms  x{row['count']:<7d} {row['name'][:90]}")
        if "align_kernels" in r:
            print("  align phase on the device: " + "; ".join(
                f"{row['name'][:60]} x{row['count']} {row['ms']:.4f} ms"
                for row in r["align_kernels"])
                + f"; kernels other than the port's own: {r['align_other_kernels']}")
        for label, t in r.get("plain_models", {}).items():
            print(f"  {label} alone (plain PyTorch): {t['seconds']:.4f}s host, "
                  f"{t['device_busy']:.4f}s device busy, {t['launches']} device kernels")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_profile.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
