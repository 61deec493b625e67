"""The reference of the fold model "CONTRAfold" (`-s CONTRAfold`): the
CONTRAfold v2 inside-outside."""

from portbench.reference import contrafold

# The consensus folds its groups of one sequence with McCaskill under
# Vienna's parameters, never with CONTRAfold, so it takes nothing from
# these posteriors (as `Dafs.run`).
CONSENSUS_LEAVES = False


def posteriors(seqs, device):
    """Each sequence's unthresholded (len, len) float32 posteriors."""
    return contrafold.batch_bp_posteriors(seqs, 0.0, device)
