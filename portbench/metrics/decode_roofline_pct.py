"""decode_roofline_pct: the least time an H100 could take for the Nussinov
and NW decodes' work (`roofline.py`, counted from the shapes and true
lengths of every decode the traced window ran) over the device time of
the calls into that layer (`trace.DecodeTimer`), in percent."""

from portbench import roofline


def read(run):
    if run.trace is None or not run.trace.decodes:
        return None
    least = sum(roofline.least_seconds(ops, nbytes) for _, ops, nbytes, _ in run.trace.decodes)
    spent = sum(sec for *_, sec in run.trace.decodes)
    return 100.0 * least / spent if spent > 0 else None
