"""The port's Nussinov and NW decoders against `dafs_tpu`, bit for bit.

The decoders are max-plus code (adds and compares only), so the port's plain
versions must equal the JAX lax paths and the Pallas kernels in interpret
mode exactly: score bits, `ss` and `al`, including problems whose true
length is below the padded length, problems of different lengths batched
together, and score matrices built with exact ties (the tie-break rules).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafs_tpu.ops import nussinov as j_nu
from dafs_tpu.ops import nussinov_pallas as j_nup
from dafs_tpu.ops import nw as j_nw
from dafs_tpu.ops import nw_pallas as j_nwp
from dafs_tpu_torch.ops import nussinov as t_nu
from dafs_tpu_torch.ops import nw as t_nw

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)


def _random_bp_matrix(rng, L):
    p = np.zeros((L, L), dtype=np.float32)
    for _ in range(int(rng.integers(L // 2, 2 * L))):
        i = int(rng.integers(0, L - 3))
        j = int(rng.integers(i + 3, L))
        p[i, j] = rng.random()
    return p


def _random_mp_matrix(rng, L1, L2):
    p = np.zeros((L1, L2), dtype=np.float32)
    for i in range(L1):
        j = int(np.clip(round(i * L2 / L1 + rng.integers(-2, 3)), 0, L2 - 1))
        p[i, j] = 0.3 + 0.7 * rng.random()
        if rng.random() < 0.3:
            p[i, int(rng.integers(0, L2))] += 0.2
    return p


def _nussinov_case(seed, ties):
    rng = np.random.default_rng(seed + 300)
    L = int(rng.integers(8, 48))
    if ties:
        # small integers: many equal candidate sums at every cell
        sm = rng.integers(-2, 3, size=(L, L)).astype(np.float32)
    else:
        p = _random_bp_matrix(rng, L)
        q = (rng.random((L, L)) * 0.2).astype(np.float32)
        sm = np.float32(4.0 * (p - 0.2) - q)
    return sm


def _port_nussinov(sms, pad):
    """Decode a list of matrices as one padded batch."""
    P = max(s.shape[0] for s in sms) + pad
    batch = np.full((len(sms), P, P), np.float32(-0.8), np.float32)
    for b, s in enumerate(sms):
        batch[b, : s.shape[0], : s.shape[0]] = s
    lens = torch.tensor([s.shape[0] for s in sms], dtype=torch.int32)
    score, ss = t_nu.decode(torch.from_numpy(batch), lens)
    return [(score[b], ss[b, : s.shape[0]].numpy()) for b, s in enumerate(sms)]


def _same(score_t, ss_t, score_j, ss_j):
    assert np.float32(score_t).view(np.int32) == np.float32(score_j).view(np.int32)
    np.testing.assert_array_equal(ss_t, np.asarray(ss_j))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_nussinov_matches_lax_and_pallas(seed, ties):
    sm = _nussinov_case(seed, ties)
    L = sm.shape[0]
    (score, ss), = _port_nussinov([sm], pad=13)
    s0, ss0 = j_nu.decode(jnp.asarray(sm), L=L)
    _same(score, ss, s0, ss0)
    s1, ss1 = j_nup.decode(jnp.asarray(sm), L=L, interpret=True)
    _same(score, ss, s1, ss1)


def test_nussinov_batch_of_lengths():
    sms = [_nussinov_case(s, ties=s % 2 == 1) for s in range(5)]
    for (score, ss), sm in zip(_port_nussinov(sms, pad=0), sms):
        s0, ss0 = j_nu.decode(jnp.asarray(sm), L=sm.shape[0])
        _same(score, ss, s0, ss0)


def _nw_case(seed, ties):
    rng = np.random.default_rng(seed + 500)
    L1 = int(rng.integers(6, 40))
    L2 = int(rng.integers(6, 40))
    if ties:
        # quarter steps: exact sums, frequent M/X/Y ties
        p = (rng.integers(0, 4, size=(L1, L2)) * (rng.random((L1, L2)) < 0.3)).astype(np.float32) / 4
        th = np.float32(0.25)
        q = (rng.integers(0, 2, size=(L1, L2)) / 4).astype(np.float32)
    else:
        p = _random_mp_matrix(rng, L1, L2)
        th = np.float32(0.01)
        q = (rng.random((L1, L2)) * 0.1).astype(np.float32)
    env = j_nw.envelope(p, th)
    np.testing.assert_array_equal(t_nw.envelope(p, th), env)
    return np.float32(p - th + q), env, th


def _port_nw(cases, pad1, pad2):
    P1 = max(sm.shape[0] for sm, _, _ in cases) + pad1
    P2 = max(sm.shape[1] for sm, _, _ in cases) + pad2
    B = len(cases)
    smp = np.zeros((B, P1, P2), np.float32)
    envf = np.zeros((B, P1 + 1), np.int32)
    envl = np.full((B, P1 + 1), P2, np.int32)
    for b, (sm, env, th) in enumerate(cases):
        L1, L2 = sm.shape
        smp[b] = -th
        smp[b, :L1, :L2] = sm
        envf[b, : L1 + 1] = env[:, 0]
        envl[b, : L1 + 1] = env[:, 1]
    l1 = torch.tensor([sm.shape[0] for sm, _, _ in cases], dtype=torch.int32)
    l2 = torch.tensor([sm.shape[1] for sm, _, _ in cases], dtype=torch.int32)
    score, al = t_nw.decode(
        torch.from_numpy(smp), torch.from_numpy(envf), torch.from_numpy(envl), l1, l2
    )
    return [(score[b], al[b, : sm.shape[0]].numpy()) for b, (sm, _, _) in enumerate(cases)]


def _jax_nw(sm, env, pallas):
    L1, L2 = sm.shape
    args = (jnp.asarray(sm), jnp.asarray(env[:, 0], jnp.int32), jnp.asarray(env[:, 1], jnp.int32))
    if pallas:
        return j_nwp.decode(*args, L1=L1, L2=L2, interpret=True)
    return j_nw.decode(*args, L1=L1, L2=L2)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_nw_matches_lax_and_pallas(seed, ties):
    case = _nw_case(seed, ties)
    (score, al), = _port_nw([case], pad1=13, pad2=29)
    for pallas in (False, True):
        s0, al0 = _jax_nw(case[0], case[1], pallas)
        _same(score, al, s0, al0)


def test_nw_batch_of_lengths():
    cases = [_nw_case(s, ties=s % 2 == 0) for s in range(5)]
    for (score, al), (sm, env, _) in zip(_port_nw(cases, 0, 0), cases):
        s0, al0 = _jax_nw(sm, env, pallas=False)
        _same(score, al, s0, al0)


def test_score_matrices_match_jax():
    rng = np.random.default_rng(0)
    p = rng.random((20, 20)).astype(np.float32)
    q = rng.random((20, 20)).astype(np.float32)
    w, th = np.float32(2.6666667), np.float32(0.2)
    got = t_nu.score_matrix(torch.tensor(w), torch.from_numpy(p), torch.from_numpy(q), torch.tensor(th))
    # exact separate rounding: the reference's float order without a fused
    # multiply-add (XLA on the CPU would fuse this one)
    np.testing.assert_array_equal(got.numpy(), np.float32(np.float32(w * np.float32(p - th)) - q))
    np.testing.assert_array_equal(
        t_nu.score_matrix_nothr(torch.from_numpy(p), torch.tensor(th)).numpy(),
        np.asarray(j_nu.score_matrix_nothr(jnp.asarray(p), th)),
    )
