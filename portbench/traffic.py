"""The one generator of the benchmark's traffic: families of RNA sequences
from a mix file (`traffic/<name>.json`) and a seed.

A mix names a bundled FASTA file (`data/`), the family sizes, the mutation
rates and a pool: `blocks` families of every size, drawn once from the
pool's own `seed`.  Each sequence of a family is a member of the FASTA
file drawn with replacement and mutated base by base: deleted with
probability `deletion`, preceded by a random base with probability
`insertion`, replaced by a random base with probability `substitution`
(the rule of `dafs_tpu_torch.parallel.dryrun.mutated_family`, copied).

A run sends the pool over and over, each pass in a new order drawn from
the run's seed: every seed sends the same families in another order, and
a window ends only where a pass ends (`at_pass_end`), so that every run
does the same work whatever its seed.  (A family's time rests mostly on
how many iterations its merges' DD takes, which swings several-fold
between families of one size: families drawn anew from each seed, or a
window cut inside a pass, made the window's mean swing with the seed far
more than with the host.)  The warm-up family has the largest size and is
the same for every seed, so that set-up does the same work.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASES = "ACGU"


@dataclasses.dataclass(frozen=True)
class Mix:
    fasta: str
    sizes: tuple
    deletion: float
    insertion: float
    substitution: float
    pool_seed: int
    blocks: int


def load_mix(name: str, root: str = HERE) -> Mix:
    with open(os.path.join(root, "traffic", f"{name}.json")) as fh:
        spec = json.load(fh)
    sizes = spec["sizes"]
    if isinstance(sizes, dict):
        sizes = list(range(sizes["min"], sizes["max"] + 1))
    m, pool = spec["mutation"], spec["pool"]
    return Mix(spec["fasta"], tuple(int(n) for n in sizes),
               float(m["deletion"]), float(m["insertion"]), float(m["substitution"]),
               int(pool["seed"]), int(pool["blocks"]))


def read_fasta(path: str) -> list[tuple[str, str]]:
    out, name, seq = [], None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(seq)))
                name, seq = line[1:].strip(), []
            elif line:
                seq.append(line.upper().replace("T", "U"))
    if name is not None:
        out.append((name, "".join(seq)))
    return out


def mutate(s: str, mix: Mix, rng: np.random.Generator) -> str:
    out = []
    for c in s:
        r = rng.random()
        if r < mix.deletion:
            continue
        if r < mix.deletion + mix.insertion:
            out.append(BASES[rng.integers(4)])
        out.append(BASES[rng.integers(4)] if rng.random() < mix.substitution else c)
    return "".join(out)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


def _family(members, n: int, mix: Mix, rng) -> list[tuple[str, str]]:
    picks = rng.integers(len(members), size=n)
    return [(f"s{k}", mutate(members[i][1], mix, rng)) for k, i in enumerate(picks)]


class Families:
    """The family stream of one mix and seed: `warm()` and then `next()`,
    each a list of (name, sequence); `at_pass_end` once `next()` has
    handed out the last family of a pass."""

    def __init__(self, mix: Mix, seed: int, root: str = HERE):
        members = read_fasta(os.path.join(root, "data", mix.fasta))
        rng = _rng(mix.pool_seed, 0)
        self.pool = [_family(members, n, mix, rng) for n in mix.sizes * mix.blocks]
        self._warm = _family(members, max(mix.sizes), mix, _rng(mix.pool_seed, 1))
        self.order = _rng(seed, 0)
        self.cycle: list[int] = []
        self.last = -1        # the pool index of the family `next()` handed out last

    def warm(self) -> list[tuple[str, str]]:
        return self._warm

    def next(self) -> list[tuple[str, str]]:
        if not self.cycle:
            self.cycle = [int(i) for i in self.order.permutation(len(self.pool))][::-1]
        self.last = self.cycle.pop()
        return self.pool[self.last]

    @property
    def at_pass_end(self) -> bool:
        return not self.cycle
