"""The copied roofline arithmetic equals `chip_smoke.py`'s at an RF00005
and an RF00017 shape."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import roofline


def _ms(ops, nbytes):
    return roofline.least_seconds(ops, nbytes) * 1e3


@pytest.mark.parametrize("lens,L", [((71, 72, 73, 74, 75, 72, 73, 71, 74, 75), 96),
                                    ((294, 297, 300, 303, 296, 299, 301, 302, 298, 295), 320)])
def test_nussinov_equals_chip_smoke(lens, L):
    t = torch.tensor(lens, dtype=torch.int32)
    assert _ms(*roofline.nussinov_work(t.numpy(), L)) == pytest.approx(
        chip_smoke.nussinov_bound(t, L)[0], rel=1e-12)


@pytest.mark.parametrize("l1s,l2s", [((75, 71), (73, 74)), ((303, 294), (300, 298))])
def test_nw_equals_chip_smoke(l1s, l2s):
    from dafs_tpu_torch.ops import nw

    rng = np.random.default_rng(0)
    L1, L2 = -(-max(l1s) // 32) * 32, -(-max(l2s) // 32) * 32
    envf = np.zeros((2, L1 + 1), np.int32)
    envl = np.zeros((2, L1 + 1), np.int32)
    for b, (l1, l2) in enumerate(zip(l1s, l2s)):
        p = np.where(rng.random((l1, l2)) < 0.05, rng.random((l1, l2)), 0.0).astype(np.float32)
        env = nw.envelope(p, 0.01)
        envf[b, : l1 + 1], envl[b, : l1 + 1] = env[:, 0], env[:, 1]
    args = (torch.zeros((2, L1, L2)), torch.from_numpy(envf), torch.from_numpy(envl),
            torch.tensor(l1s, dtype=torch.int32), torch.tensor(l2s, dtype=torch.int32))
    mine = roofline.nw_work(envf, envl, np.array(l1s), L1)
    assert _ms(*mine) == pytest.approx(chip_smoke.nw_bound(args)[0], rel=1e-12)
