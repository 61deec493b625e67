"""consensus_prep_s: the host prep seconds of the consensus calls
(`Result.consensus_calls[*]["prep_seconds"]`), per family."""


def read(run):
    if not run.families:
        return None
    return sum(c.get("prep_seconds", 0.0) for f in run.families
               for c in f.consensus_calls) / len(run.families)
