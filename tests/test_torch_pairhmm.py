"""The port's ProbCons pair-HMM against `dafs_tpu` on the CPU.

The port's passes run their plain PyTorch versions here (kernels K1/K2 need
the card).  The JAX side runs the lax path and the Pallas kernels in
interpret mode.  Tolerance atol = rtol = 1e-5, the JAX package's own bound
between those two paths: XLA on the CPU contracts multiply-adds into fused
multiply-adds, which the port (like the TPU) does not, so the two differ in
the last bits of the LOG_ADD polynomials.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dafs_tpu.ops import logspace as j_ls
from dafs_tpu.ops import pairhmm as j_ph
from dafs_tpu.ops import pairhmm_pallas as j_php
from dafs_tpu.parallel.mesh import force_single_device
from dafs_tpu.fasta import Fasta as JFasta
from dafs_tpu.models import align_models as j_am
from dafs_tpu_torch.fasta import Fasta as TFasta
from dafs_tpu_torch.models import align_models as t_am
from dafs_tpu_torch.ops import logspace as t_ls
from dafs_tpu_torch.ops import pairhmm as t_ph

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rna(rng, n):
    return "".join(rng.choice(list("ACGU"), size=n))


def _batch(seed, B=4, lo=5, hi=32, lmax=32):
    """Ragged lengths inside one padded bucket."""
    rng = np.random.default_rng(seed)
    s1 = [_rna(rng, int(rng.integers(lo, hi + 1))) for _ in range(B)]
    s2 = [_rna(rng, int(rng.integers(lo, hi + 1))) for _ in range(B)]
    c1, n1 = t_ph.encode_batch(s1, lmax)
    c2, n2 = t_ph.encode_batch(s2, lmax)
    return c1, n1, c2, n2


def _port(c1, n1, c2, n2):
    args = [torch.from_numpy(a) for a in (c1, n1, c2, n2)]
    return t_ph.forward_backward_posterior(*args, t_ph.tables("cpu")).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_posteriors_match_lax(seed):
    c1, n1, c2, n2 = _batch(seed)
    want = np.asarray(j_ph.forward_backward_posterior(
        jnp.asarray(c1), jnp.asarray(n1), jnp.asarray(c2), jnp.asarray(n2),
        l1max=32, l2max=32,
    ))
    got = _port(c1, n1, c2, n2)
    np.testing.assert_allclose(got, want, **TOL)


def test_posteriors_match_pallas_interpret():
    c1, n1, c2, n2 = _batch(7, B=3, lo=9, hi=30)
    orig_call = pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig_call(*a, **kw)

    with mock.patch.object(pl, "pallas_call", interp_call):
        want = np.asarray(j_php.forward_backward_posterior(
            jnp.asarray(c1), jnp.asarray(n1), jnp.asarray(c2), jnp.asarray(n2),
            l1max=32, l2max=32,
        ))
    np.testing.assert_allclose(_port(c1, n1, c2, n2), want, **TOL)


def test_forward_captures_are_end_cells():
    """fcap holds the forward values the totals read; the end capture is the
    (len1, len2) cell of the full forward table."""
    c1, n1, c2, n2 = _batch(3)
    args = [torch.from_numpy(a) for a in (c1, n1, c2, n2)]
    fm, fcap = t_ph.forward_plain(*args, t_ph.tables("cpu"))
    for b in range(len(n1)):
        assert fcap[b, 0] == fm[b, n1[b], n2[b]]
        assert fcap[b, 3] == fm[b, 1, 1]


def test_all_pairs_matches_jax():
    rng = np.random.default_rng(11)
    seqs = [_rna(rng, n) for n in (20, 27, 31, 24)]
    with force_single_device():
        want = j_am.ProbCons(0.0).all_pairs([JFasta(f"s{i}", s) for i, s in enumerate(seqs)])
    got = t_am.ProbCons(0.0).all_pairs([TFasta(f"s{i}", s) for i, s in enumerate(seqs)], "cpu")
    np.testing.assert_allclose(got, want, **TOL)


def test_logspace_matches_jax():
    x = np.linspace(-20.0, 0.0, 4001, dtype=np.float32)
    y = np.linspace(5.0, -3.0, 4001, dtype=np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        t_ls.probcons_exp(tx).numpy(), np.asarray(j_ls.probcons_exp(x)), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(
        t_ls.log_add(tx, ty).numpy(), np.asarray(j_ls.log_add(x, y)), atol=1e-6, rtol=1e-6)
    d = np.linspace(0.0, 7.5, 1001, dtype=np.float32)
    np.testing.assert_allclose(
        t_ls.lookup(torch.from_numpy(d)).numpy(), np.asarray(j_ls.lookup(d)), atol=1e-7, rtol=1e-6)
