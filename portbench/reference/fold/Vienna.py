"""The reference of the fold model "Vienna" (`-s Vienna`): McCaskill with
Vienna's parameters."""

from portbench.reference import mccaskill
from portbench.reference.typedefs import CUTOFF

# The consensus takes Vienna's parameters under "Vienna", so a group of one
# sequence takes its consensus from these posteriors (as `Dafs.run`).
CONSENSUS_LEAVES = True


def posteriors(seqs, device):
    """Each sequence's unthresholded (len, len) float32 posteriors."""
    return mccaskill.batch_bp_posteriors_fast(seqs, 0.0, device, bl=False)


def constrained_posteriors(seqs, constraints, device):
    """Each sequence's (len, len) float32 posteriors under its constraint
    string, cut at CUTOFF (the fold model's threshold): the bp-update's
    re-fold."""
    return mccaskill.batch_bp_posteriors_fast(seqs, CUTOFF, device, bl=False,
                                              constraints=constraints)
