"""The reference of the align model "CONTRAlign" (`-a CONTRAlign`): the
CONTRAlign pair-CRF."""

from portbench.reference import paircrf


def posteriors(seqs1, seqs2, th_a, device):
    """Each pair's (len1, len2) float32 match posteriors, entries kept only
    above `th_a`."""
    return paircrf.batch_posteriors(seqs1, seqs2, th_a, device)
