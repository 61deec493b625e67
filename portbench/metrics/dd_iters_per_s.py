"""dd_iters_per_s: the DD iterations of every merge (`Result.device_dd`),
summed over the window, over the summed merge DD seconds."""


def read(run):
    iters = sum(t for f in run.families for t, _ in f.device_dd)
    secs = sum(f.phase_seconds.get("merge DD", 0.0) for f in run.families)
    return iters / secs if secs > 0 and iters > 0 else None
