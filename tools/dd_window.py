"""One cell through `portbench/span_run.py`, with the DD loop's and the
CONTRA models' counters.

    python3 tools/dd_window.py --workload NAME --seed N --seconds S --trace 0|1

Runs `span_run.main` with the same arguments (its line on standard output,
its extra lines on standard error) and adds to standard error, where the
runner handed its spans to a reader (`--trace 1`):

- `dd_counters: {...}`, the counters "iterations" and "step_kernel_bodies"
  summed over the `dd.loop` spans of the measured window (and of the whole
  run), with the loops that ran any body through the plain step.  On the
  card every body goes through the step kernels (`ops/dd_step_cuda`), so
  the two sums are equal.
- `contra_counters: {...}`, the window's `paircrf.batch` and
  `contrafold.batch` spans: how many, their seconds and their counters
  summed (`paircrf.batch`'s `kernel_batches` beside `diagonals` and
  `cells`: on the card every batch runs the pair-CRF kernels, so it equals
  the span count; `contrafold.batch`'s `graph_captures` and
  `graph_replays` beside `steps` and `cells`: on the card every bucket is
  a replay, so `graph_replays` equals the span count and
  `graph_replays - graph_captures` counts the buckets whose graph was
  already there), and the values of the readers `crf_kernels_per_diag` and
  `crf_busy_pct` (`portbench/metrics/`), which `BENCHMARK.json` does not
  list yet (None where the window ran no pair-CRF or has no device trace).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def sums(loops) -> dict:
    it = sum(sp.counts.get("iterations", 0) for sp in loops)
    kb = sum(sp.counts.get("step_kernel_bodies", 0) for sp in loops)
    plain = sum(sp.counts.get("step_kernel_bodies", 0) < sp.counts.get("iterations", 0)
                for sp in loops)
    return dict(loops=len(loops), iterations=it, step_kernel_bodies=kb, loops_not_all_kernels=plain)


def span_sums(recs, name: str, counters) -> dict:
    batches = [sp for sp in recs if sp.name == name]
    out = dict(spans=len(batches), seconds=sum(sp.t1 - sp.t0 for sp in batches))
    out.update({c: sum(sp.counts.get(c, 0) for sp in batches) for c in counters})
    return out


def main(argv=None) -> int:
    from portbench import harness, span_run, spans

    runs = []
    window_spans = spans.window_spans

    def keep(run):
        runs.append(run)
        return window_spans(run)

    spans.window_spans = keep
    span_run.T_PROCESS = T_PROCESS
    try:
        rc = span_run.main(argv)
    finally:
        spans.window_spans = window_spans
    if runs:
        run = runs[-1]
        window = [sp for sp in window_spans(run) if sp.name == "dd.loop"]
        every = [sp for sp in run.spans if sp.name == "dd.loop"]
        print("dd_counters: " + json.dumps(dict(window=sums(window), run=sums(every))),
              file=sys.stderr)
        recs = window_spans(run)
        contra = dict(paircrf=span_sums(recs, "paircrf.batch",
                                        ("diagonals", "cells", "kernel_batches")),
                      contrafold=span_sums(recs, "contrafold.batch",
                                           ("steps", "cells", "graph_captures", "graph_replays")))
        for name in ("crf_kernels_per_diag", "crf_busy_pct"):
            contra[name] = harness.load_reader(name)(run)
        print("contra_counters: " + json.dumps(contra), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
