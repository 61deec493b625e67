"""The port's McCaskill BL* fold against `dafs_tpu` on the CPU.

Tolerances are the JAX package's own between its fast and slow kernels
(tests/test_mccaskill_fast.py: atol 3e-5, rtol 3e-3): the stencil
contractions and row sums reduce in another order than XLA's.
"""

import numpy as np
import pytest
import torch

from dafs_tpu.fasta import Fasta as JFasta
from dafs_tpu.models import fold_models as j_fm
from dafs_tpu.ops import mccaskill as j_mc
from dafs_tpu.parallel.mesh import force_single_device
from dafs_tpu_torch import params
from dafs_tpu_torch.fasta import Fasta as TFasta
from dafs_tpu_torch.models import fold_models as t_fm
from dafs_tpu_torch.ops import mccaskill as t_mc
from dafs_tpu_torch.ops import mccaskill_kernel as t_mk
from tests import oracle_mccaskill

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=3e-3)
OVERFLOW = "GGGGGGCCCCCC" * 6  # Q >= 1e25 at the first scale: one retry


def _rna(rng, n):
    return "".join(rng.choice(list("ACGU"), size=n))


def _first_q(seq):
    L = t_mc._round_up(len(seq), 32)
    s, pt, ap, au = t_mc._prepare(seq, L, None)
    t = lambda a: torch.from_numpy(np.asarray(a)[None])  # noqa: E731
    codes = t_mc.kmer_codes(t(s))
    _, Q = t_mk.mccaskill_fast(
        t(s), t(pt), t(ap), t(au), torch.tensor([len(seq)], dtype=torch.int32),
        torch.tensor([np.exp(-0.6)], dtype=torch.float32), codes,
        params.to_device(t_mc._fast_tabs(True), "cpu"),
    )
    return float(Q[0])


@pytest.mark.parametrize("seq", ["GGGAAAACCC", "GCGCUUCGGCGC", "AUAUAUAUAUAUAU"])
def test_matches_enumeration_oracle(seq):
    want = oracle_mccaskill.exact_bpp(seq, bl=True)
    got = t_mc.batch_bp_posteriors_fast([seq], 0.0, "cpu")[0]
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-4)


def test_batch_matches_jax_with_retry():
    rng = np.random.default_rng(1)
    seqs = [OVERFLOW, _rna(rng, 70), _rna(rng, 81)]
    assert _first_q(OVERFLOW) >= 1e25  # the ladder has to step the scale
    want = j_mc.batch_bp_posteriors_fast(seqs, 0.0)
    got = t_mc.batch_bp_posteriors_fast(seqs, 0.0, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert got[0].max() > 0.5


def test_kmer_codes_match_jax():
    """The k-mer codes, built with torch, equal `dafs_tpu`'s numpy ones, Ns
    and the sequence's end included."""
    rng = np.random.default_rng(4)
    seqs = [_rna(rng, n) for n in (5, 17, 40)] + ["GGNGAAACCNCUUCGGAN", "ACGUN"]
    L = 64
    S = np.stack([t_mc._prepare(s, L, None)[0] for s in seqs])
    got = t_mc.kmer_codes(torch.from_numpy(S))
    for ci, k in enumerate((5, 6, 8)):
        want = np.stack([j_mc._kmer_codes(S[b], k, L) for b in range(len(seqs))])
        np.testing.assert_array_equal(got[ci].numpy(), want)
        assert got[ci].dtype == torch.int32 and want.any()


def test_buckets_and_threshold_match_jax():
    rng = np.random.default_rng(2)
    seqs = [_rna(rng, n) for n in (21, 30, 40, 47)]  # two 32-length buckets
    with force_single_device():
        want = j_fm.RNAfold(True, 0.01).all_seqs([JFasta(f"s{i}", s) for i, s in enumerate(seqs)])
    got = t_fm.RNAfold(True, 0.01).all_seqs([TFasta(f"s{i}", s) for i, s in enumerate(seqs)], "cpu")
    np.testing.assert_allclose(got, want, **TOL)
