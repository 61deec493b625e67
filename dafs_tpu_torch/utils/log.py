"""spdlog-equivalent logging (reference verbosity mapping src/dafs.cpp:1665-1677).

verbose 0 -> warn, 1 -> info, 2 -> debug; format mirrors spdlog's default
``[timestamp] [level] message`` closely enough for human diffing.

Copied from the JAX package's module of the same name: importing any
`dafs_tpu` module imports JAX (its package `__init__` does), and the port
must run where JAX is not installed.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("dafs_tpu_torch")


def set_verbosity(verbose: int) -> None:
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s"))
        logger.addHandler(h)
    if verbose <= 0:
        logger.setLevel(logging.WARNING)
    elif verbose == 1:
        logger.setLevel(logging.INFO)
    else:
        logger.setLevel(logging.DEBUG)
