"""The reference of the fold model "Vienna" (`-s Vienna`): McCaskill with
Vienna's parameters."""

from portbench.reference import mccaskill

# The consensus takes Vienna's parameters under "Vienna", so a group of one
# sequence takes its consensus from these posteriors (as `Dafs.run`).
CONSENSUS_LEAVES = True


def posteriors(seqs, device):
    """Each sequence's unthresholded (len, len) float32 posteriors."""
    return mccaskill.batch_bp_posteriors_fast(seqs, 0.0, device, bl=False)
