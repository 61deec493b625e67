"""crf_busy_pct: the share of the pair-CRF's `paircrf.batch` spans in
which the device ran something (the union of its activity inside them
over their summed length), in percent, over the traced window."""

from portbench import spans


def read(run):
    batches = [(sp.t0, sp.t1) for sp in spans.named(spans.window_spans(run), "paircrf.batch")]
    dev = spans.device_spans(run)
    total = sum(e - s for s, e in batches)
    if not dev or total <= 0:
        return None
    return 100.0 * spans.busy_within(batches, dev) / total
