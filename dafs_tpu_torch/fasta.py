"""FASTA I/O with the reference's parsing semantics (src/fa.cpp:37-87).

The reference accepts interleaved sequence lines and optional structure
annotation lines (any line starting with one of ``()[].?xle`` or space is a
structure line; sequence lines are truncated at the first non-alpha char).

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import dataclasses

_STRUCT_CHARS = set("()[].?xle ")


@dataclasses.dataclass
class Fasta:
    name: str
    seq: str
    str_: str = ""

    def __len__(self) -> int:
        return len(self.seq)


def load_fasta(path: str) -> list[Fasta]:
    """Parse a FASTA file exactly like the reference (src/fa.cpp:37-87)."""
    data: list[Fasta] = []
    name: str | None = None
    seq_parts: list[str] = []
    str_parts: list[str] = []

    def flush() -> None:
        if name:
            seq = "".join(seq_parts)
            sstr = "".join(str_parts)
            assert not sstr or len(seq) == len(sstr)
            data.append(Fasta(name, seq, sstr))

    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                flush()
                name = line[1:]
                seq_parts = []
                str_parts = []
                continue
            if not line:
                # reference reads line[0] of an empty std::string -> '\0',
                # strchr("()[].?xle ", '\0') returns the terminator => struct
                # branch, which then appends nothing. Treat as no-op.
                continue
            if line[0] not in _STRUCT_CHARS:
                # sequence line: keep leading alpha run (src/fa.cpp:64-68)
                i = 0
                while i < len(line) and line[i].isalpha():
                    i += 1
                seq_parts.append(line[:i])
            else:
                # structure line: keep leading run of structure chars
                i = 0
                while i < len(line) and line[i] in _STRUCT_CHARS:
                    i += 1
                str_parts.append(line[:i])
    flush()
    return data
