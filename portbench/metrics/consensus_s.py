"""consensus_s: the host seconds per family of the merges' input prep with
the consensus mixed in and of the final structure's (`phase_seconds`
"merge avg+alifold" + "final avg_bp (+alifold)")."""

from portbench.readers import per_family


def read(run):
    return per_family(run, ("merge avg+alifold", "final avg_bp (+alifold)"))
