"""The program's spans of a run, for the readers of the span metrics.

`dafs_tpu_torch.utils.spans` records, inside the program, one span per
piece of work (`family`, its phases, `merge.layer`, `dd.solve` with
`dd.prep`, `dd.upload`, `dd.loop`, `dd.check`, `dd.readback`,
`consensus.call`, `projection.average`, ...), on `time.perf_counter()`,
the clock `trace.DeviceTrace` puts the profiler's device intervals on.
A reader finds the spans in `run.spans` and the device intervals, (start,
end, name), in `run.trace.device_spans`; where the run has neither (a run
that did not record them) it reads nothing.  Only duck-typed attributes
of a span are read (`id`, `parent`, `family`, `name`, `t0`, `t1`,
`attrs`, `counts`), so nothing here imports the program.
"""

from __future__ import annotations

import bisect

from portbench.trace import union

COPIES = ("Memcpy", "Memset")  # device activity that is no kernel


def window_spans(run) -> list:
    """The spans of the families the window kept: those whose family's
    root lies inside one of `run.families`' host intervals."""
    recs = getattr(run, "spans", None) or []
    if not recs or not run.families:
        return []
    bounds = sorted((f.start, f.end) for f in run.families)
    keep = set()
    for sp in recs:
        if sp.parent is None:
            i = bisect.bisect_right(bounds, (sp.t0, float("inf"))) - 1
            if i >= 0 and bounds[i][0] <= sp.t0 and sp.t1 <= bounds[i][1]:
                keep.add(sp.id)
    return [sp for sp in recs if sp.family in keep]


def device_spans(run) -> list:
    return list(getattr(run.trace, "device_spans", None) or []) if run.trace else []


def named(recs, name: str) -> list:
    return [sp for sp in recs if sp.name == name]


def children(recs, parents, name: str) -> list:
    ids = {sp.id for sp in parents}
    return [sp for sp in recs if sp.name == name and sp.parent in ids]


def within(intervals, points) -> int:
    """How many of `points` lie inside one of the disjoint `intervals`
    ((start, end) pairs)."""
    ivs = sorted(intervals)
    starts = [s for s, _ in ivs]
    n = 0
    for p in points:
        i = bisect.bisect_right(starts, p) - 1
        if i >= 0 and p <= ivs[i][1]:
            n += 1
    return n


def busy_within(intervals, dev) -> float:
    """Seconds of the disjoint `intervals` in which some device activity
    of `dev` ((start, end, name)) ran."""
    busy = 0.0
    for lo, hi in intervals:
        for s, e in union((max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi):
            busy += e - s
    return busy


def self_segments(recs) -> list:
    """(start, end, name) of the parts of each span that none of its
    children covers: the innermost span at every instant."""
    kids: dict = {}
    for sp in recs:
        kids.setdefault(sp.parent, []).append(sp)
    segs = []
    for sp in recs:
        t = sp.t0
        for c in sorted(kids.get(sp.id, ()), key=lambda c: c.t0):
            if c.t0 > t:
                segs.append((t, c.t0, sp.name))
            t = max(t, c.t1)
        if sp.t1 > t:
            segs.append((t, sp.t1, sp.name))
    return segs


def idle_by_span(gaps, recs, top: int = 15) -> dict:
    """{name: seconds} of the device's idle `gaps` by the innermost span
    open over them, largest first; time outside every family span reads
    "between families"."""
    from portbench.harness import idle_by_activity

    return dict(idle_by_activity(gaps, self_segments(recs), top=top))
