"""The port's RNAalifold consensus against `dafs_tpu` on the CPU.

The host tables and the per-sequence planes must be bit-equal to the JAX
package's.  The consensus is held to the JAX fast path at the tolerance the
JAX package holds its own fast path to its reference kernel
(tests/test_alifold_fast.py: rtol 2e-4, atol 1e-6): the stencil and row sums
reduce in another order than XLA's.  Each distinct (n_seq, padded length,
BCUT) shape costs the JAX side an XLA compile of 12-16 s, so the cases share
shapes.
"""

import os

import numpy as np
import pytest
import torch

from dafs_tpu.ops import alifold as j_ali
from dafs_tpu.ops import alifold_kernel as j_ak
from dafs_tpu_torch import params
from dafs_tpu_torch.fasta import Fasta
from dafs_tpu_torch.models import fold_models
from dafs_tpu_torch.ops import alifold as t_ali
from dafs_tpu_torch.ops import alifold_kernel as t_ak
from tests import oracle_alifold

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-6)

# tests/test_alifold_fast.py's cases: (3, 32) and (2, 32) shapes
CASES = [
    ["GGGAAACCC", "GGCAAAGCC", "GGGAAACCC"],
    ["GGGC-AAAGCCC", "GG-CAAA-GCCC", "GGGCAA--GCCC"],
    [
        "GGCGCGAAAGCGAAUAGCGCC-",
        "GG-GCGAAAGC--AUAGC-CCA",
        "GGCGC-AAAGCGAAUAG-GCCU",
    ],
    ["GGGGAAAACCCC----", "GGGG----AAAACCCC"],
]
# tests/test_alifold.py's cases for the enumeration oracle
ORACLE_CASES = [
    ["GGGAAAACCC", "GGGAAAACCC", "GGGAAAACCC"],
    ["GGCAAAAGCC", "GUCAAAAGAC", "GGCAAAAGCC"],
    ["GGGAAAACCC", "GG-AAAAC-C"],
    ["GCGCUUCGGCGC", "GCGC-UCGGCGC", "GCACUUCGGUGC"],
]
# Q >= 1e25 at the first per-column scale: the ladder steps once
OVERFLOW = ["GGGGGGCCCCCC" * 6] * 2
# groups of RF00017's TPU run whose consensus feeds a later merge
RF00017_GROUPS = [
    ["M32222-1/953-1250", "AE013320-1/6338-6044"],
    ["M32222-1/953-1250", "AE013320-1/6338-6044", "AE010387-1/4828-4528",
     "U67510-1/7006-7301", "M22560-1/129-422"],
    ["Z29104-1/1-303", "X65991-1/1-302", "AC002512-1/76041-75744",
     "X01055-1/1-297", "Z30973-1/7231-6935"],
]


def _bits_equal(got, want, key=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, key
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def _jax_t2(bl, nseq):
    """The JAX package's kernel table dict (dafs_tpu/ops/alifold.py:732-742)."""
    t = j_ali._tables(bl, nseq)
    return dict(
        stack=t["stack"], i11=t["int11"], i21=t["int21"], i22=t["int22"],
        internal=t["internal"], ninio=t["ninio"], bulge=t["bulge"],
        hairpin=t["hairpin"], mmH=t["mismatchH"], mmI=t["mismatchI"],
        mm1n=t["mismatch1nI"], mm23=t["mismatch23I"], mmM=t["mismatchM"],
        mmExt=t["mismatchExt"], d5=t["dangle5"], d3=t["dangle3"],
        tau=t["terminal_au"], mli=t["ml_intern"],
        mlc=t["ml_closing"] ** nseq, tri=t["triloop"],
        tetra=t["tetraloop"], hexa=t["hexaloop"],
        lxc=np.exp(-t["lxc"] * 10.0 / t["kt"]),
    )


@pytest.mark.parametrize("bl", [True, False])
def test_tables_bit_equal(bl):
    nseq = 3
    t, t2, loop_tabs, spec_tabs, gtabs = t_ali._tables(bl, nseq)
    jt = j_ali._tables(bl, nseq)
    assert sorted(t) == sorted(jt)
    for k in jt:
        _bits_equal(t[k], jt[k], k)
    jt2 = _jax_t2(bl, nseq)
    for got, want in ((loop_tabs, j_ak.build_loop_tables(jt2)),
                      (spec_tabs, j_ak.build_special_tables(jt2)),
                      (gtabs, j_ak.build_gtabs(jt2))):
        assert sorted(got) == sorted(want)
        for k in want:
            _bits_equal(got[k], want[k], k)


@pytest.mark.parametrize("bl", [True, False])
def test_planes_bit_equal(bl):
    seqs = CASES[2]
    x = t_ali._inputs(seqs, bl, None)
    jt2 = _jax_t2(bl, len(seqs))
    want = j_ak.build_planes(jt2, x["S"], x["S5"], x["S3"], x["a2s"], x["pt7"],
                             *x["codes"], x["n"], len(seqs), x["L"] + 2)
    assert sorted(x["planes"]) == sorted(want)
    for k in want:
        _bits_equal(x["planes"][k], want[k], k)


def test_seq_planes_bit_equal():
    import jax.numpy as jnp

    seqs = CASES[2]
    x = t_ali._inputs(seqs, True, None)
    NS, Lp = len(seqs), x["L"] + 2
    got = t_ak.build_seq_planes(
        params.to_device(x["gtabs"], "cpu"),
        *(torch.from_numpy(x[k]) for k in ("S", "S5", "S3")),
    )
    Sb = np.zeros_like(x["S5b"])
    Sb[:, t_ak.PAD : t_ak.PAD + Lp] = x["S"]
    want = j_ak.build_seq_planes(
        {k: jnp.asarray(v) for k, v in x["gtabs"].items()},
        jnp.asarray(Sb), jnp.asarray(x["S5b"]), jnp.asarray(x["S3b"]),
        jnp.ones(NS, jnp.float32), L=x["L"], NS=NS,
    )
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        _bits_equal(g.astype(w.dtype) if g.dtype.kind == "i" else g, w, k)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("bl", [True, False])
def test_consensus_matches_jax(case, bl):
    seqs = CASES[case]
    want = j_ali.consensus_bp(seqs, 0.0, bl=bl, fast=True)
    got = t_ali.Alifold(0.0, bl).consensus(seqs, "cpu")
    np.testing.assert_allclose(got, want, **TOL)
    assert got.max() > 0.05


def test_constraint_matches_jax():
    seqs = ["GGGC-AAAGCCC", "GG-CAAA-GCCC"]
    con = "(((x....x)))"
    want = j_ali.consensus_bp(seqs, 0.0, constraint=con, fast=True)
    got = t_ali.Alifold(0.0).consensus(seqs, "cpu", con)
    np.testing.assert_allclose(got, want, **TOL)
    free = t_ali.Alifold(0.0).consensus(seqs, "cpu")
    assert not np.array_equal(got, free)
    assert got[3, :].max() == 0.0 and got[:, 8].max() == 0.0  # the 'x' columns


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)))
def test_matches_enumeration_oracle(case):
    seqs = ORACLE_CASES[case]
    want = oracle_alifold.exact_consensus_bpp(seqs)
    want[want <= 1e-6] = 0.0  # Vienna's plist cutoff, applied by the kernel too
    got = t_ali.Alifold(0.0).consensus(seqs, "cpu")
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)


def test_bcut_is_bitwise_invisible():
    """The computed B-group support cut equals the full 31x31 block bit for
    bit, on a gappy alignment whose windows exercise loop sizes around the
    bound (tests/test_alifold_fast.py:77-81)."""
    aln = [
        "GGGCAACGACGG--UUCGUCG--AAACCC",
        "GGGCAACG--GGCAUUCG--GCAAACCC-",
        "GGGCA--GACGGCAUU--UCGGCAAACC-",
    ]
    ali = t_ali.Alifold(0.0)
    cut = ali.consensus(aln, "cpu")
    full = ali.consensus(aln, "cpu", bcut=31)
    assert [c["bcut"] for c in ali.calls] == [8, 31]
    _bits_equal(cut, full)
    assert cut.max() > 0.1


def test_retry_ladder_matches_jax():
    ali = t_ali.Alifold(0.0)
    got = ali.consensus(OVERFLOW, "cpu")
    assert ali.calls[0]["attempts"] == 2  # the first scale overflowed
    want = j_ali.consensus_bp(OVERFLOW, 0.0, fast=True)
    np.testing.assert_allclose(got, want, **TOL)
    assert got.max() > 0.5
    # the object keeps the scale that stabilized Q: the next call of the
    # same (n_seq, length) starts there
    again = ali.consensus(OVERFLOW, "cpu")
    assert ali.calls[1]["attempts"] == 1
    np.testing.assert_allclose(again, got, **TOL)


@pytest.mark.parametrize("constraint", [None, "((((....))))" + "." * 14])
def test_single_sequence_route_matches_jax(constraint):
    """One ungapped sequence goes to McCaskill; held at the McCaskill
    tolerance (tests/test_torch_mccaskill.py)."""
    seq = "GGGAAAACCCAUGCGCUUCGGCGCAU"
    ali = t_ali.Alifold(0.0)
    got = ali.consensus([seq], "cpu", constraint)
    assert ali.calls[0]["route"] == "mccaskill"
    want = j_ali.consensus_bp([seq], 0.0, constraint=constraint, fast=True)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-3)
    assert (got[(got > 0)] > 1e-6).all()


def test_fold_stage_serves_single_sequence_groups():
    """An unconstrained group of one ungapped sequence is served from the
    fold stage's McCaskill posteriors of that sequence (the same run, kept
    before the fold threshold); held to the JAX single-sequence route at the
    McCaskill tolerance."""
    seqs = ["GGGAAAACCCAUGCGCUUCGGCGCAU", "GCGCUUCGGCGCAAAAGGGAAACCC"]
    fm = fold_models.RNAfold(True, 0.01)
    posts = fm.batch_bp_posteriors(seqs, "cpu", th=0.0)
    ali = t_ali.Alifold(0.0)
    ali.leaves = dict(zip(seqs, posts))
    for s in seqs:
        got = ali.consensus([s], "cpu")
        want = j_ali.consensus_bp([s], 0.0, fast=True)
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-3)
    # a constrained group runs McCaskill
    ali.consensus([seqs[0]], "cpu", "((((....))))" + "." * 14)
    assert [c["route"] for c in ali.calls] == ["fold stage", "fold stage", "mccaskill"]
    # the fold stage's tensor cut from the same posteriors equals a fresh fold
    fa = [Fasta(f"s{i}", s) for i, s in enumerate(seqs)]
    _bits_equal(fm.all_seqs(fa, "cpu", posts), fm.all_seqs(fa, "cpu"))


def _snapshot_group(path, names):
    """The recorded final rows of `names`, all-gap columns dropped: the
    group's own alignment in the recorded run (later merges only insert
    all-gap columns into a group)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    rows = dict(zip((l[2:] for l in lines[3::2]), lines[4::2]))
    rows = [rows[n] for n in names]
    keep = [k for k in range(len(rows[0])) if any(r[k] != "-" for r in rows)]
    return ["".join(r[k] for k in keep) for r in rows]


@pytest.mark.slow
@pytest.mark.parametrize("group", range(len(RF00017_GROUPS)))
def test_consensus_matches_jax_at_rf00017_size(group):
    """The consensus at the main path's widths: a group of RF00017's TPU
    run ((NS, n) = (2, 302), (5, 320), (5, 337)), against the JAX fast path
    from a cold pf-scale warm start on both sides."""
    path = os.path.join(os.path.dirname(__file__), "snapshots", "rf00017_default_tpu.txt")
    seqs = _snapshot_group(path, RF00017_GROUPS[group])
    j_ali._SC_CACHE.clear()
    want = j_ali.consensus_bp(seqs, 0.0, bl=True, fast=True)
    got = t_ali.Alifold(0.0).consensus(seqs, "cpu")
    np.testing.assert_allclose(got, want, **TOL)
    assert got.max() > 0.5
