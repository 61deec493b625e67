"""dd_kernels_per_iter: the device kernels (copies and sets left out) that
start inside the merges' `dd.solve` spans, over the loop bodies their
`dd.loop` spans ran (counter "iterations"), over the traced window."""

from portbench import spans


def read(run):
    recs = spans.window_spans(run)
    dev = spans.device_spans(run)
    solves = spans.named(recs, "dd.solve")
    iters = sum(sp.counts.get("iterations", 0)
                for sp in spans.children(recs, solves, "dd.loop"))
    if not dev or not iters:
        return None
    starts = [s for s, _, name in dev if not name.startswith(spans.COPIES)]
    return spans.within([(sp.t0, sp.t1) for sp in solves], starts) / iters
