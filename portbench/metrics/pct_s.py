"""pct_s: the consistency layer's host seconds per family: the similarity
matrix and the two 3-way PCTs (`phase_seconds` "similarity" + "PCT")."""

from portbench.readers import per_family


def read(run):
    return per_family(run, ("similarity", "PCT"))
