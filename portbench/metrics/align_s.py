"""align_s: the align phase's host seconds per family (`phase_seconds["align"]`)."""

from portbench.readers import per_family


def read(run):
    return per_family(run, ("align",))
