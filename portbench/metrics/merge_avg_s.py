"""merge_avg_s: the host seconds per family of the alignment averages of
the posteriors, in the merges and the final structure (spans
`projection.average`)."""

from portbench import spans


def read(run):
    recs = spans.named(spans.window_spans(run), "projection.average")
    if not recs:
        return None
    return sum(sp.t1 - sp.t0 for sp in recs) / len(run.families)
