"""The port's multi-device execution (`dafs_tpu_torch.parallel.mesh`, the
gates in the models and in `consistency`, `parallel.dryrun`) on the CPU.

On virtual meshes of 2, 3 and 8 shards (`mesh.virtual_mesh`) every sharded
stage must be bit-equal to the unsharded port, batches that do not divide
evenly and shards that hold only padding included.  Against `dafs_tpu`'s
sharded functions on conftest's 8-device XLA mesh the tolerances are those
of the existing parity tests: pair-HMM posteriors atol = rtol = 1e-5
(tests/test_torch_pairhmm.py), McCaskill atol 3e-5, rtol 3e-3
(tests/test_torch_mccaskill.py), PCT atol 2e-6
(tests/test_torch_consistency.py).  Inputs are mutated tRNAs of
tests/data/RF00005_0.fa, made with numpy from a seed.  The whole pipeline
on a mesh is in tests/test_torch_dryrun.py.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dafs_tpu import consistency as j_co
from dafs_tpu.parallel import mesh as j_mesh
from dafs_tpu_torch import consistency as t_co
from dafs_tpu_torch.fasta import load_fasta
from dafs_tpu_torch.models import align_models, fold_models
from dafs_tpu_torch.ops import mccaskill, pairhmm
from dafs_tpu_torch.parallel import dryrun, mesh
from tests.test_torch_consistency import _family

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = [2, 3, 8]
PAIR_TOL = dict(atol=1e-5, rtol=1e-5)
FOLD_TOL = dict(atol=3e-5, rtol=3e-3)
PCT_TOL = dict(atol=2e-6)
CPU = torch.device("cpu")


def _trnas(n, seed):
    """n mutated tRNAs of RF00005 (71-84 nt, one 32-length bucket)."""
    seqs = [f.seq for f in load_fasta(os.path.join(ROOT, "tests", "data", "RF00005_0.fa"))]
    return dryrun.mutated_family(seqs, n, seed)


def _pairs(seqs):
    idx = [(i, j) for i in range(len(seqs)) for j in range(i + 1, len(seqs))]
    return [seqs[i] for i, _ in idx], [seqs[j] for _, j in idx]


def _constraints(seqs):
    """Per sequence: one forced pair (the first canonical pair 12 apart),
    two positions forced unpaired ('x'), the rest free."""
    can = {"GC", "CG", "AU", "UA", "GU", "UG"}
    out = []
    for s in seqs:
        c = ["?"] * len(s)
        i = next(i for i in range(5, len(s) - 12) if s[i] + s[i + 12] in can)
        c[i], c[i + 12] = "(", ")"
        c[1] = c[len(s) - 2] = "x"
        out.append("".join(c))
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


# ------------------------------------------------------------- the mesh --


@pytest.mark.parametrize("req,count,ctx,want", [
    ("cpu", 0, None, ["cpu"]),
    ("cuda:1", 3, None, ["cuda:1"]),
    ("cuda", 3, None, ["cuda:0", "cuda:1", "cuda:2"]),
    ("cuda", 3, "single", ["cuda:0"]),
    ("cpu", 0, 3, ["cpu"] * 3),
    ("cuda:2", 3, 2, ["cuda:2"] * 2),
    ("cuda", 3, 2, ["cuda:0", "cuda:1"]),
    ("cuda", 1, 2, ["cuda:0"] * 2),
])
def test_work_devices(req, count, ctx, want, monkeypatch):
    """"cuda" is every visible card, "cuda:k" that card, "cpu" the CPU;
    force_single_device keeps the first; virtual_mesh(n) takes the first n
    named, or n shards of the first where fewer are named."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if ctx is None:
        got, n = mesh.work_devices(req), mesh.work_device_count(req)
    elif ctx == "single":
        with mesh.virtual_mesh(8), mesh.force_single_device():
            got, n = mesh.work_devices(req), mesh.work_device_count(req)
    else:
        with mesh.virtual_mesh(ctx):
            got, n = mesh.work_devices(req), mesh.work_device_count(req)
    assert [str(d) for d in got] == want and n == len(want)


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.work_devices("cuda")
    with mesh.force_single_device(), pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.work_devices("cuda")


def test_shard_slices_pad_as_dafs_tpu():
    """n rows over s shards: padded to a multiple of s, shard k holding
    rows [k*per, (k+1)*per), as `dafs_tpu` lays a batch over its mesh."""
    assert mesh.shard_slices(10, 3) == (12, [slice(0, 4), slice(4, 8), slice(8, 12)])
    assert mesh.shard_slices(3, 8)[0] == 8
    assert mesh.shard_slices(4, 2) == (4, [slice(0, 2), slice(2, 4)])


# ------------------------------------------- sharded against unsharded --

PAIR_SEQS = _trnas(5, seed=1)  # 10 pairs: not a multiple of 3 or 8


@pytest.fixture(scope="module")
def unsharded_pairs():
    return pairhmm.batch_posteriors(*_pairs(PAIR_SEQS), 0.01, CPU)


@functools.cache
def _sharded_pairs(shards):
    with mesh.virtual_mesh(shards):  # through the gate
        return align_models.ProbCons(0.01).batch_pair_posteriors(*_pairs(PAIR_SEQS), CPU)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pair_posteriors_bit_equal(shards, unsharded_pairs):
    _equal(_sharded_pairs(shards), unsharded_pairs)


FOLD_SEQS = _trnas(2, seed=2)  # 2 rows: 3 and 8 shards hold padding-only shards


@pytest.fixture(scope="module")
def unsharded_folds():
    return {c: mccaskill.batch_bp_posteriors_fast(
        FOLD_SEQS, 0.0, CPU, constraints=_constraints(FOLD_SEQS) if c else None)
        for c in (False, True)}


@functools.cache
def _sharded_folds(shards, constrained):
    cons = _constraints(FOLD_SEQS) if constrained else None
    with mesh.virtual_mesh(shards):  # through the gate
        return fold_models.RNAfold(True, 0.0).batch_bp_posteriors(FOLD_SEQS, CPU,
                                                                  constraints=cons)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_bp_posteriors_bit_equal(shards, constrained, unsharded_folds):
    _equal(_sharded_folds(shards, constrained), unsharded_folds[constrained])


def test_padding_rows_do_not_lengthen_the_ladder(monkeypatch):
    """A sequence whose partition function overflows at the first scale
    takes one more attempt; the length-1 padding rows never ask for one,
    so the sharded ladder makes as many attempts as the unsharded one."""
    from dafs_tpu_torch.ops import mccaskill_kernel

    seqs = ["GGGGGGCCCCCC" * 6, *FOLD_SEQS]  # 3 rows over 2 shards: one padding row
    calls = []
    real = mccaskill_kernel.mccaskill_fast
    monkeypatch.setattr(mccaskill_kernel, "mccaskill_fast",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    want = mccaskill.batch_bp_posteriors_fast(seqs, 0.0, CPU)
    attempts = len(calls)
    calls.clear()
    got = mesh.sharded_bp_posteriors(seqs, 0.0, devices=[CPU] * 2)
    assert attempts >= 2 and len(calls) == 2 * attempts and set(calls) == {2}
    _equal(got, want)


PCT_FAMILY = _family(11, N=7, lens=(12, 14, 13, 12, 15, 11, 14))  # 21 pairs, 7 sequences


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pct_bit_equal(shards):
    mp, bp, sim, lens = PCT_FAMILY
    want_mp = t_co.relax_matching_probability(mp, sim, lens, 0.25, CPU)
    want_bp = t_co.relax_basepairing_probability(bp, mp, sim, lens, 0.25, CPU)
    with mesh.virtual_mesh(shards):
        _equal([t_co.relax_matching_probability(mp, sim, lens, 0.25, CPU)], [want_mp])
        _equal([t_co.relax_basepairing_probability(bp, mp, sim, lens, 0.25, CPU)], [want_bp])


@pytest.mark.parametrize("chunked", ["match", "basepair"])
def test_pct_rows_do_not_depend_on_the_worklist_length(chunked):
    """One worklist entry alone gives the bits it gives inside the whole
    worklist: every product has the chunk's shape."""
    mp, bp, sim, lens = PCT_FAMILY
    m, b = torch.from_numpy(mp), torch.from_numpy(bp)
    if chunked == "match":
        _, xs, ys, W, sw = t_co.match_worklist(sim, 0.25)
        whole = t_co.relax_match_rows(m, xs, ys, W, sw)
        one = t_co.relax_match_rows(m, xs[5:6], ys[5:6], W[5:6], sw[5:6])
    else:
        xs, W, sw = t_co.basepair_worklist(sim, 0.25)
        whole = t_co.relax_basepair_rows(b, m, xs, W, sw)
        one = t_co.relax_basepair_rows(b, m, xs[5:6], W[5:6], sw[5:6])
    assert whole.shape[0] == len(W)
    _equal([one[0].numpy()], [whole[5].numpy()])


# ------------------------------------------ against dafs_tpu's mesh --

# `dafs_tpu`'s sharded pair posteriors and folds on an 8-device XLA mesh, in
# a subprocess whose XLA code generation stops below FMA
# (`--xla_cpu_max_isa=AVX`; tests/test_torch_pipeline.py): by default XLA on
# the CPU contracts multiply-adds into fused multiply-adds, which the port
# never does, and at tRNA lengths that moves posteriors by up to 2.7e-5.
_JAX_SHARDED = """
import json, sys
import jax, numpy as np
from dafs_tpu.parallel import mesh
job = json.load(sys.stdin)
assert jax.device_count() == 8
m = mesh.make_mesh()
out = {}
for k, p in enumerate(mesh.sharded_pair_posteriors(job["s1"], job["s2"], 0.01, m)):
    out[f"pair{k}"] = p
for c, cons in (("free", None), ("constrained", job["cons"])):
    for k, p in enumerate(mesh.sharded_bp_posteriors(job["fold"], 0.0, constraints=cons,
                                                     mesh=m)):
        out[f"{c}{k}"] = p
np.savez(job["out"], **out)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh") / "sharded.npz"
    s1, s2 = _pairs(PAIR_SEQS)
    job = json.dumps(dict(s1=s1, s2=s2, fold=FOLD_SEQS, cons=_constraints(FOLD_SEQS),
                          out=str(out)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_SHARDED], input=job, text=True,
                          capture_output=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return dict(np.load(out))


def test_pair_posteriors_match_dafs_tpu_sharded(jax_sharded):
    for k, g in enumerate(_sharded_pairs(8)):
        np.testing.assert_allclose(g, jax_sharded[f"pair{k}"], **PAIR_TOL)


@pytest.mark.parametrize("constrained", [False, True])
def test_bp_posteriors_match_dafs_tpu_sharded(constrained, jax_sharded):
    for k, g in enumerate(_sharded_folds(8, constrained)):
        want = jax_sharded[f"{'constrained' if constrained else 'free'}{k}"]
        np.testing.assert_allclose(g, want, **FOLD_TOL)


@pytest.mark.parametrize("w_pct", [0.25, -1.0])
def test_pct_matches_dafs_tpu_shard_map(w_pct):
    """`dafs_tpu.consistency.relax_*` take their shard_map path here (the
    process has conftest's 8 XLA devices); the port splits over 8 virtual
    shards."""
    mp, bp, sim, lens = PCT_FAMILY
    assert jax.device_count() == 8 and j_mesh.work_device_count() == 8
    want_mp = j_co.relax_matching_probability(mp, sim, lens, w_pct)
    want_bp = j_co.relax_basepairing_probability(bp, mp, sim, lens, w_pct)
    with mesh.virtual_mesh(8):
        got_mp = t_co.relax_matching_probability(mp, sim, lens, w_pct, CPU)
        got_bp = t_co.relax_basepairing_probability(bp, mp, sim, lens, w_pct, CPU)
    np.testing.assert_allclose(got_mp, want_mp, **PCT_TOL)
    np.testing.assert_allclose(got_bp, want_bp, **PCT_TOL)
