"""fold_s: the fold phase's host seconds per family (`phase_seconds["fold"]`)."""

from portbench.readers import per_family


def read(run):
    return per_family(run, ("fold",))
