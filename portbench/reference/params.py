"""Parameter tables as tensors on a device.

The port builds its tables with its own copies of the host modules
(`models/probcons_params.log_tables()` for the ProbCons pair-HMM,
`ops/mccaskill._fast_tabs(bl)` for the BL* McCaskill model), as numpy
arrays in the same layout as the JAX package's; this converter moves such a
dict, from either package, to float32 tensors on one device.  The tests hold
the port's tables bit-equal to the JAX package's passed through it.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(tables: dict, device) -> dict[str, torch.Tensor]:
    """{name: array or scalar} -> {name: float32 tensor on `device`}
    (0-dim for scalars), values unchanged."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        for k, v in tables.items()
    }
