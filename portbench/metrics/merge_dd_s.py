"""merge_dd_s: the merges' DD host seconds per family (`phase_seconds["merge DD"]`)."""

from portbench.readers import per_family


def read(run):
    return per_family(run, ("merge DD",))
