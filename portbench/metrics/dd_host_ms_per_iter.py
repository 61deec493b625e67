"""dd_host_ms_per_iter: the host milliseconds of the merges' `dd.loop`
spans less their blocking reads of the `done` mask (`dd.check`), over the
loop bodies they ran (counter "iterations"), over the traced window."""

from portbench import spans


def read(run):
    recs = spans.window_spans(run)
    loops = spans.named(recs, "dd.loop")
    iters = sum(sp.counts.get("iterations", 0) for sp in loops)
    if not iters:
        return None
    host = (sum(sp.t1 - sp.t0 for sp in loops)
            - sum(sp.t1 - sp.t0 for sp in spans.children(recs, loops, "dd.check")))
    return 1e3 * host / iters
