"""Run one cell with the program's span recorder on.

    python3 portbench/span_run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, as `portbench/run.py` runs it, inside
`dafs_tpu_torch.utils.spans.record()` (set-up, window and check).  With
`--trace 0` the line's `family_s` and `setup_s` are those of a run with
recording on, to set against `run.py`'s in the same call (the recorder's
cost).  With `--trace 1` the harness's `Run` gets the spans (`spans`) and
its trace the profiler's device intervals (`device_spans`), the readers of
`SPAN_METRICS` join the cell's per-layer metrics, and standard error gets
two more lines: `idle_by_span: {...}`, the window's device idle seconds by
the innermost program span open over them (top 15), and `span_checks:
{...}`, the spans held to the harness's own intervals.

The harness has no place for the spans yet: this script puts them there by
replacing `harness.Run` and `trace.DeviceTrace` for its own process.  Once
`harness.run_cell` records the spans itself and `BENCHMARK.json` lists
`SPAN_METRICS`, `run.py --trace 1` reports them and this script goes.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ["default-trna", "default-trna50"]
SPAN_METRICS = [
    dict(name="dd_kernels_per_iter", unit="kernels/iter", better="lower",
         source="device_trace", layer="merges", moves="family_s", workloads=CELLS),
    dict(name="dd_host_ms_per_iter", unit="ms/iter", better="lower",
         source="program_span", layer="merges", moves="family_s", workloads=CELLS),
    dict(name="dd_busy_pct", unit="%", better="higher",
         source="device_trace", layer="merges", moves="family_s", workloads=CELLS),
    dict(name="dd_prep_s", unit="s", better="lower",
         source="program_span", layer="merges", moves="family_s", workloads=CELLS),
    dict(name="merge_avg_s", unit="s", better="lower",
         source="program_span", layer="consensus", moves="family_s", workloads=CELLS),
]


def span_checks(run, line) -> dict:
    """The spans against the harness's own intervals: family roots inside
    the families' intervals, the `dd.solve` seconds over the "merge DD"
    phase seconds, and the idle seconds inside `dd.solve` over the
    breakdown's "merge DD" idle seconds."""
    from portbench import spans

    recs = spans.window_spans(run)
    solves = [(sp.t0, sp.t1) for sp in spans.named(recs, "dd.solve")]
    phase_dd = sum(f.phase_seconds.get("merge DD", 0.0) for f in run.families)
    out = dict(families=len(run.families),
               roots_inside=sum(sp.parent is None for sp in recs),
               dd_solve_over_merge_dd=(sum(e - s for s, e in solves) / phase_dd
                                       if phase_dd else None))
    dev = spans.device_spans(run)
    idle_dd = dict(line.get("breakdown", {}).get("idle_gaps", [])).get("merge DD")
    if dev and idle_dd:
        inside = sum(e - s for s, e in solves) - spans.busy_within(solves, dev)
        out["dd_solve_idle_over_breakdown_merge_dd"] = inside / idle_dd
    return out


def run_with_spans(cell, seed: int, seconds: float, trace: bool, device: str,
                   t_process: float):
    """`harness.run_cell` inside the program's span recorder, the spans and
    device intervals handed to the readers.  Returns (line, the check's
    lines and, traced, `idle_by_span` and `span_checks`)."""
    from dafs_tpu_torch.utils import spans as program_spans
    from portbench import harness, spans
    from portbench import trace as device_trace

    kept: dict = {}

    class KeepTrace(device_trace.DeviceTrace):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["trace"] = self
            return out

    @dataclasses.dataclass
    class SpanRun(harness.Run):
        def __post_init__(self):
            self.spans = kept["recs"]
            if self.trace is not None:
                self.trace.device_spans = kept["trace"].spans
            kept["run"] = self

    saved = device_trace.DeviceTrace, harness.Run
    device_trace.DeviceTrace, harness.Run = KeepTrace, SpanRun
    try:
        with program_spans.record() as recs:
            kept["recs"] = recs
            line, lines = harness.run_cell(cell, seed, seconds, trace, device, t_process)
    finally:
        device_trace.DeviceTrace, harness.Run = saved
    run = kept["run"]
    if trace and run.families:
        if "trace" in kept:
            gaps = kept["trace"].idle_gaps(run.families[0].start, run.families[-1].end)
            idle = spans.idle_by_span(gaps, spans.window_spans(run))
            lines = lines + ["idle_by_span: " + json.dumps(idle)]
        lines = lines + ["span_checks: " + json.dumps(span_checks(run, line))]
    return line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    bench["per_layer"] += [m for m in SPAN_METRICS if args.workload in m["workloads"]]
    cell = harness.Cell(bench, args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"span_run: the cell needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    line, lines = run_with_spans(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                                 T_PROCESS)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
