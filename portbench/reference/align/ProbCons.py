"""The reference of the align model "ProbCons" (`-a ProbCons`, the
default): the pair-HMM."""

from portbench.reference import pairhmm


def posteriors(seqs1, seqs2, th_a, device):
    """Each pair's (len1, len2) float32 match posteriors, entries kept only
    above `th_a`."""
    return pairhmm.batch_posteriors(seqs1, seqs2, th_a, device)
