"""crf_kernels_per_diag: the device kernels (copies and sets left out) that
start inside the pair-CRF's `paircrf.batch` spans, over the loop steps
their counter "diagonals" ran (forward and backward), over the traced
window."""

from portbench import spans


def read(run):
    batches = spans.named(spans.window_spans(run), "paircrf.batch")
    dev = spans.device_spans(run)
    diags = sum(sp.counts.get("diagonals", 0) for sp in batches)
    if not dev or not diags:
        return None
    starts = [s for s, _, name in dev if not name.startswith(spans.COPIES)]
    return spans.within([(sp.t0, sp.t1) for sp in batches], starts) / diags
