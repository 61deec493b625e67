"""Helpers of the metric readers (`metrics/<name>.py`)."""

from __future__ import annotations


def per_family(run, phases) -> float | None:
    """The host seconds of `phases` (`Result.phase_seconds` keys), summed
    over the window's families and divided by their count."""
    if not run.families:
        return None
    return sum(f.phase_seconds.get(k, 0.0) for f in run.families for k in phases) / len(run.families)
