"""glibc rand() replica (TYPE_3 additive-feedback generator, seed 1).

DAFS::refine uses bare rand() (src/dafs.cpp:1548) with no srand call, i.e.
glibc's deterministic seed-1 stream.  Replicated here so `-r N` refinement
partitions match the reference binary exactly on glibc systems.

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations


class GlibcRand:
    def __init__(self, seed: int = 1):
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            r[i] = (16807 * r[i - 1]) % 2147483647
            if r[i] < 0:
                r[i] += 2147483647
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) % (1 << 32)
        self.r = r
        self.i = 344

    def rand(self) -> int:
        r = self.r
        v = (r[self.i - 31] + r[self.i - 3]) % (1 << 32)
        r.append(v)
        self.i += 1
        return v >> 1
