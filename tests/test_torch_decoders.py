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


# -- short problems, signed zeros, and batches mixing them with long ones --
#
# The CUDA kernels split each cell's bifurcation maximum across lanes and
# keep the chosen split's own value (K3), and run NW as a wavefront over
# lanes (K4); these cases pin what they must reproduce: true lengths 0-5
# inside a padded problem, scores of exactly +0.0 and -0.0, and short and
# long problems in one padded batch.


def _quarter_steps(rng, shape, neg_zero):
    """Scores in quarter steps; with `neg_zero` half the zeros are -0.0."""
    sm = (rng.integers(-4, 5, size=shape) / 4).astype(np.float32)
    if neg_zero:
        sm[(sm == 0) & (rng.random(shape) < 0.5)] = np.float32(-0.0)
    return sm


def _nussinov_padded(sm, n, P):
    """The port's decode of one problem of true length n padded to P, and
    the JAX lax and Pallas (interpret) decodes of the same padded matrix."""
    padded = np.full((P, P), np.float32(-0.8), np.float32)
    padded[:n, :n] = sm[:n, :n]
    score, ss = t_nu.decode(torch.from_numpy(padded[None]), torch.tensor([n], dtype=torch.int32))
    jax_out = [j_nu.decode(jnp.asarray(padded), n, L=P),
               j_nup.decode(jnp.asarray(padded), n, L=P, interpret=True)]
    return (score[0], ss[0].numpy()), jax_out


@pytest.mark.parametrize("neg_zero", [False, True])
@pytest.mark.parametrize("n", range(6))
def test_nussinov_short_lengths(n, neg_zero):
    rng = np.random.default_rng(900 + n)
    sm = _quarter_steps(rng, (n, n), neg_zero)
    (score, ss), jax_out = _nussinov_padded(sm, n, P=8)
    for s_j, ss_j in jax_out:
        _same(score, ss, s_j, ss_j)


def test_nussinov_signed_zero_scores():
    """Only zeros of both signs and a few positive pairs: the pair rule
    (score > 0) must treat -0.0 as 0, and dp sums of +0.0 and -0.0 keep the
    reference's bits."""
    rng = np.random.default_rng(31)
    L = 24
    sm = np.where(rng.random((L, L)) < 0.5, np.float32(-0.0), np.float32(0.0)).astype(np.float32)
    for _ in range(12):
        i = int(rng.integers(0, L - 4))
        sm[i, int(rng.integers(i + 4, L))] = np.float32(0.25)
    (score, ss), jax_out = _nussinov_padded(sm, L, P=32)
    for s_j, ss_j in jax_out:
        _same(score, ss, s_j, ss_j)


def test_nussinov_batch_short_and_long():
    rng = np.random.default_rng(41)
    sms = [_quarter_steps(rng, (n, n), neg_zero=True) for n in range(6)]
    sms += [_nussinov_case(s, ties=True) for s in range(2)]
    sms += [_nussinov_case(s, ties=False) for s in range(2, 4)]
    for (score, ss), sm in zip(_port_nussinov(sms, pad=5), sms):
        n = sm.shape[0]
        P = n + 8
        padded = np.full((P, P), np.float32(-0.8), np.float32)
        padded[:n, :n] = sm
        s0, ss0 = j_nu.decode(jnp.asarray(padded), n, L=P)
        _same(score, ss, s0, np.asarray(ss0)[:n])


def _nw_small_case(rng, l1, l2, neg_zero):
    th = np.float32(0.25)
    p = (rng.integers(0, 4, size=(l1, l2)) * (rng.random((l1, l2)) < 0.4)).astype(np.float32) / 4
    q = (rng.integers(0, 2, size=(l1, l2)) / 4).astype(np.float32)
    sm = np.float32(p - th + q)
    if neg_zero:
        sm[(sm == 0) & (rng.random((l1, l2)) < 0.7)] = np.float32(-0.0)
    env = j_nw.envelope(p, th)
    np.testing.assert_array_equal(t_nw.envelope(p, th), env)
    return sm, env, th


def _nw_padded_against_jax(cases, P1, P2):
    """Decode `cases` as one padded (P1, P2) batch in the port; compare each
    with the JAX lax and Pallas (interpret) decodes of its padded arrays."""
    B = len(cases)
    smp = np.zeros((B, P1, P2), np.float32)
    envf = np.zeros((B, P1 + 1), np.int32)
    envl = np.full((B, P1 + 1), P2, np.int32)
    for b, (sm, env, th) in enumerate(cases):
        l1, l2 = sm.shape
        smp[b] = -th
        smp[b, :l1, :l2] = sm
        envf[b, : l1 + 1] = env[:, 0]
        envl[b, : l1 + 1] = env[:, 1]
    l1s = np.array([sm.shape[0] for sm, _, _ in cases], np.int32)
    l2s = np.array([sm.shape[1] for sm, _, _ in cases], np.int32)
    score, al = t_nw.decode(*(torch.from_numpy(a) for a in (smp, envf, envl, l1s, l2s)))
    for b in range(B):
        args = (jnp.asarray(smp[b]), jnp.asarray(envf[b]), jnp.asarray(envl[b]),
                int(l1s[b]), int(l2s[b]))
        for s_j, al_j in (j_nw.decode(*args, L1=P1, L2=P2),
                          j_nwp.decode(*args, L1=P1, L2=P2, interpret=True)):
            if l1s[b] == 0:
                # dp[0][l2] = 0; JAX leaves this score undefined (the lax
                # path reads the last padded row, the Pallas kernel never
                # writes it), so only the alignment is compared
                assert np.float32(score[b]).view(np.int32) == 0
                np.testing.assert_array_equal(al[b].numpy(), np.asarray(al_j))
            else:
                _same(score[b], al[b].numpy(), s_j, al_j)


@pytest.mark.parametrize("neg_zero", [False, True])
@pytest.mark.parametrize("l1,l2", [(0, 0), (0, 4), (4, 0), (1, 1), (2, 5), (5, 2), (3, 3), (5, 5)])
def test_nw_short_lengths(l1, l2, neg_zero):
    rng = np.random.default_rng(1000 + 7 * l1 + l2)
    _nw_padded_against_jax([_nw_small_case(rng, l1, l2, neg_zero)], P1=8, P2=8)


def test_nw_batch_short_and_long():
    rng = np.random.default_rng(51)
    cases = [_nw_small_case(rng, l1, l2, neg_zero=True) for l1, l2 in ((0, 3), (1, 1), (5, 2))]
    cases += [_nw_case(s, ties=s % 2 == 0) for s in range(3)]
    P1 = max(sm.shape[0] for sm, _, _ in cases) + 3
    P2 = max(sm.shape[1] for sm, _, _ in cases) + 5
    _nw_padded_against_jax(cases, P1, P2)


@pytest.mark.parametrize("B", [1, 2, 4, 8, 10, 16, 33, 66, 67, 200])
@pytest.mark.parametrize("L", [32, 96, 352, 384, 1024])
def test_k3_cluster_size_rule(B, L):
    """CTAs per problem: one CTA up to L = 128; above that a power of two up
    to 8, enough warps for the widest diagonal (about L/2 cells), and
    B * C within the H100's 132 SMs unless B alone exceeds them."""
    from dafs_tpu_torch.ops import nussinov_cuda

    C = nussinov_cuda.cluster_size(B, L)
    assert C in (1, 2, 4, 8)
    assert B * C <= max(nussinov_cuda.SMS, B)
    if L <= 128:
        assert C == 1
    else:
        want = -(-(L // 2) // nussinov_cuda.WARPS_PER_CTA)
        assert C >= min(want, 8) or B * 2 * C > nussinov_cuda.SMS


def test_k4_shared_memory_limit_covers_main_path():
    """The wrapper's limit (the K4 kernel's ring and code table in one
    block's shared memory) lies far beyond the main path's merged
    alignments (under 600 columns), and is exact at the widest shape."""
    from dafs_tpu_torch.ops import nw_cuda

    for L in (96, 320, 352, 384, 416, 600):
        assert nw_cuda.smem_bytes(L, L) <= nw_cuda.MAX_SMEM_BYTES
    assert nw_cuda.smem_bytes(771, 1023) <= nw_cuda.MAX_SMEM_BYTES
    assert nw_cuda.smem_bytes(772, 1023) > nw_cuda.MAX_SMEM_BYTES
