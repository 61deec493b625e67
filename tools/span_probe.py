#!/usr/bin/env python3
"""The port's default path under its span recorder: where it waits for
the card, and what recording costs.

    python3 tools/span_probe.py [--family tests/data/RF00005_0.fa | family-50]
        [--dd-update subgradient] [--pairs 8]

Runs the family once to warm up (the kernel library builds).  Then, in
one process so that the host's speed is the same for both sides, `--pairs`
pairs of runs with the recorder (`dafs_tpu_torch.utils.spans`) off and on,
in turns (off, on, on, off, ...): each run's wall (host clock, ended by a
synchronise) and the spans a run records, and the host microseconds of
one empty span, off and on.  Last, one run under the
recorder with `torch.cuda.set_sync_debug_mode("warn")`, each warning
stamped with `time.perf_counter()`: every synchronising CUDA call laid to
the innermost span open when it was made, and those of the DD loop
(`dd.loop`'s own time) split into the loop's set-up (before its first
`dd.check`) and its body (after).  Prints one JSON line.  `family-50` is
`chip_smoke.family50()`.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default=os.path.join(ROOT, "tests", "data", "RF00005_0.fa"))
    ap.add_argument("--dd-update", default="subgradient")
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args(argv)

    import statistics

    import torch

    from dafs_tpu_torch import api, pipeline
    from dafs_tpu_torch.fasta import load_fasta
    from dafs_tpu_torch.utils import spans
    from portbench.spans import self_segments

    if not torch.cuda.is_available():
        print("span_probe: needs a CUDA card", file=sys.stderr)
        return 2
    if args.family == "family-50":
        import chip_smoke

        fa = chip_smoke.family50()
    else:
        fa = load_fasta(args.family)

    def run():
        d = api.make_dafs(pipeline.Options(dd_update=args.dd_update), device="cuda")
        t0 = time.perf_counter()
        d.run(fa)
        torch.cuda.synchronize()
        return d, time.perf_counter() - t0

    run()
    walls = {"off": [], "on": []}
    n_spans = []
    for k in range(2 * args.pairs):
        on = k % 4 in (1, 2)
        if on:
            with spans.record() as recs:
                walls["on"].append(run()[1])
            n_spans.append(len(recs))
        else:
            walls["off"].append(run()[1])
    med = {k: statistics.median(v) for k, v in walls.items()}
    # the recorder's own work: one empty span off and on, on this host
    per_span = {}
    for on in (False, True):
        with spans.record() if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(100_000):
                with spans.span("probe"):
                    pass
            per_span["on" if on else "off"] = (time.perf_counter() - t0) / 100_000

    stamps = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: stamps.append((time.perf_counter(), str(a[0])))
        with spans.record() as recs:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                d, _ = run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    syncs = [t for t, msg in stamps if "synchroniz" in msg]
    segs = sorted(self_segments(recs))
    starts = [s for s, _, _ in segs]
    by_span: dict = {}
    where = []
    for t in syncs:
        i = bisect.bisect_right(starts, t) - 1
        name = segs[i][2] if i >= 0 and t <= segs[i][1] else "outside"
        by_span[name] = by_span.get(name, 0) + 1
        where.append((t, name))
    loop = {"set-up": 0, "body": 0}
    for sp in recs:
        if sp.name != "dd.loop":
            continue
        first = min((c.t0 for c in recs if c.parent == sp.id), default=sp.t1)
        for t, name in where:
            if name == "dd.loop" and sp.t0 <= t <= sp.t1:
                loop["set-up" if t < first else "body"] += 1
    out = dict(
        device=torch.cuda.get_device_name(0), family=os.path.basename(args.family),
        n=len(fa), dd_update=args.dd_update,
        walls=walls, median_off=med["off"], median_on=med["on"],
        on_over_off=med["on"] / med["off"], spans_a_run=n_spans,
        span_us_off=1e6 * per_span["off"], span_us_on=1e6 * per_span["on"],
        syncs=len(syncs), by_span=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        dd_loop=loop,
        dd_layers=sum(sp.name == "dd.loop" for sp in recs),
        dd_iterations=sum(sp.counts.get("iterations", 0) for sp in recs if sp.name == "dd.loop"),
        dd_checks=sum(sp.name == "dd.check" for sp in recs),
        merges=len(d.result["device_dd"]),
        other_warnings=sorted({msg[:120] for _, msg in stamps if "synchroniz" not in msg}),
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
