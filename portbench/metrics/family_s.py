"""family_s: the window's whole time, from its start to the end of its last
family, over the families it completed (host clock)."""


def read(run):
    return run.window_s / len(run.families) if run.families else None
