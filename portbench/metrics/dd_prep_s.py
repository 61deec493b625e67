"""dd_prep_s: the host seconds per family of the batched DD's host prep,
copies to the device and readback (spans `dd.prep`, `dd.upload`,
`dd.readback`)."""

from portbench import spans


def read(run):
    recs = [sp for sp in spans.window_spans(run)
            if sp.name in ("dd.prep", "dd.upload", "dd.readback")]
    if not recs:
        return None
    return sum(sp.t1 - sp.t0 for sp in recs) / len(run.families)
