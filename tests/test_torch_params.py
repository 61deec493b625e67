"""The port's parameter tables and host-module copies against `dafs_tpu`.

The port builds its tables from its own copies of the host modules (the
JAX package cannot be imported where JAX is absent); they must be bit-equal
to the JAX package's tables passed through `dafs_tpu_torch.params`.
"""

import numpy as np
import pytest
import torch

from dafs_tpu import guide_tree as j_tree
from dafs_tpu import projection as j_proj
from dafs_tpu.ops import energy_params as j_ep
from dafs_tpu.ops import mccaskill as j_mc
from dafs_tpu.ops import pairhmm as j_ph
from dafs_tpu.typedefs import AlnRow as JAlnRow
from dafs_tpu_torch import guide_tree as t_tree
from dafs_tpu_torch import params
from dafs_tpu_torch import projection as t_proj
from dafs_tpu_torch.ops import energy_params as t_ep
from dafs_tpu_torch.ops import mccaskill as t_mc
from dafs_tpu_torch.ops import pairhmm as t_ph
from dafs_tpu_torch.typedefs import AlnRow as TAlnRow

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, k
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), k


def test_probcons_tables_bit_equal():
    _assert_bit_equal(t_ph.tables("cpu"), params.to_device(j_ph.tables(), "cpu"))


@pytest.mark.parametrize("bl", [True, False])
def test_mccaskill_tables_bit_equal(bl):
    _assert_bit_equal(
        params.to_device(t_mc._fast_tabs(bl), "cpu"),
        params.to_device(j_mc._fast_tabs(bl), "cpu"),
    )


def test_energy_encodings_equal():
    seq = "ACGUTNacgut"
    np.testing.assert_array_equal(t_ep.encode_rna(seq), j_ep.encode_rna(seq))
    np.testing.assert_array_equal(t_ep.BP_PAIR, j_ep.BP_PAIR)
    np.testing.assert_array_equal(t_ep.RTYPE, j_ep.RTYPE)


@pytest.mark.parametrize("seed", range(3))
def test_guide_tree_copy_equal(seed):
    rng = np.random.default_rng(seed)
    N = 6
    sim = rng.random((N, N)).astype(np.float32)
    sim = np.float32((sim + sim.T) / 2)
    np.fill_diagonal(sim, 1.0)
    names = [f"s{i}" for i in range(N)]
    tj, tt = j_tree.build_tree(sim), t_tree.build_tree(sim)
    assert tt == tj
    assert t_tree.print_tree(tt, names) == j_tree.print_tree(tj, names)


@pytest.mark.parametrize("seed", range(3))
def test_projection_copy_equal(seed):
    rng = np.random.default_rng(seed)
    L1, L2, N = 9, 7, 5
    masks1 = [rng.random(L1) < 0.8 for _ in range(2)]
    masks2 = [rng.random(L2) < 0.8 for _ in range(2)]
    mp = (rng.random((N, N, L1, L1)) * (rng.random((N, N, L1, L1)) < 0.3)).astype(np.float32)
    bp = np.triu(rng.random((N, L1, L1)).astype(np.float32), 1)
    z = np.full(L1, -1, np.int64)
    z[[0, 2, 5]] = [0, 3, 6]
    x = np.full(L1, -1, np.int64)
    x[1], x[4] = 7, 8
    y = np.full(L2, -1, np.int64)
    y[0] = 5

    def rows(cls):
        return ([cls(i, m) for i, m in enumerate(masks1)],
                [cls(2 + i, m) for i, m in enumerate(masks2)])

    a1j, a2j = rows(JAlnRow)
    a1t, a2t = rows(TAlnRow)
    np.testing.assert_array_equal(
        t_proj.average_matching_probability(mp, a1t, a2t),
        j_proj.average_matching_probability(mp, a1j, a2j),
    )
    np.testing.assert_array_equal(
        t_proj.average_basepairing_probability(bp, a1t),
        j_proj.average_basepairing_probability(bp, a1j),
    )
    for rj, rt in zip(j_proj.project_alignment(a1j, a2j, z),
                      t_proj.project_alignment(a1t, a2t, z)):
        assert rj.seq_id == rt.seq_id
        np.testing.assert_array_equal(rj.mask, rt.mask)
    for gj, gt in zip(j_proj.project_secondary_structure(x, y, z),
                      t_proj.project_secondary_structure(x, y, z)):
        np.testing.assert_array_equal(gj, gt)
