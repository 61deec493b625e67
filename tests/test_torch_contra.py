"""The port's CONTRA models against `dafs_tpu` on the CPU: the CONTRA half
of `ops/logspace.py`, the CONTRAlign pair-CRF (`ops/paircrf.py`) and the
CONTRAfold inside-outside (`ops/contrafold.py`), with their parameter
tables.

The JAX references run once for the module, in one subprocess with XLA's
CPU code generation capped below FMA (`--xla_cpu_max_isa=AVX`), as the
port never contracts a multiply and an add.  Tolerances:

- the logspace polynomials and the pair-CRF are bit-equal (the pair-CRF's
  only transcendental is Fast_Exp's libm `exp` above 0; the bound asked is
  1e-6);
- CONTRAfold reduces with exact log-sum-exp through `log1p` and `exp`,
  whose torch and XLA versions differ in the last bits: 1e-5 against
  `dafs_tpu`, 5e-5 against the tRNA snapshot (the JAX package's own bound);
- the enumeration oracles at the JAX package's tolerances.

Run with `-s` to see the measured maxima.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dafs_tpu.models import contralign_params as j_cp
from dafs_tpu.ops import contrafold_params as j_cfp
from dafs_tpu_torch.fasta import load_fasta
from dafs_tpu_torch.models import contralign_params as t_cp
from dafs_tpu_torch.ops import contrafold as t_cf
from dafs_tpu_torch.ops import contrafold_params as t_cfp
from dafs_tpu_torch.ops import logspace as t_ls
from dafs_tpu_torch.ops import paircrf as t_crf
from tests import oracle_contrafold, oracle_contralign
from tests.test_untested_features import _constrained_exact_bpp

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def _rna(rng, n):
    return "".join(rng.choice(list("ACGU"), size=int(n)))


def _boundaries(points):
    """Each point and its float32 neighbours."""
    out = []
    for p in points:
        p = np.float32(p)
        out += [np.nextafter(p, np.float32(-np.inf)), p, np.nextafter(p, np.float32(np.inf))]
    return np.array(out, np.float32)


LEPO_X = np.concatenate([
    np.linspace(0.0, 12.5, 5001, dtype=np.float32),
    _boundaries([u for _, u in t_ls.LEPO_PIECES[:-1]] + [t_ls.CONTRA_LEPO_MAX]),
])
FEXP_X = np.concatenate([
    np.linspace(-12.0, 50.0, 6201, dtype=np.float32),
    _boundaries([lo for _, lo in t_ls.FEXP_PIECES] + [46.052]),
    # 0 itself but not its subnormal neighbours: XLA on the CPU flushes
    # subnormal inputs to zero, torch does not
    np.array([0.0, -1e-30, 1e-30], np.float32),
])
_rng = np.random.default_rng(5)
LP_X = np.concatenate([_rng.uniform(-30, 30, 3000), [-2e20, -2e20, -1e20, 3.0, -1e20, 0.0]]).astype(np.float32)
LP_Y = np.concatenate([
    LP_X[:1000] + np.float32(t_ls.CONTRA_LEPO_MAX) * _rng.choice([-1, 1], 1000)
    * (1 + _rng.uniform(-1e-6, 1e-6, 1000)),
    _rng.uniform(-30, 30, 2000), [-2e20, 5.0, -2e20, -1e20, 2.5, -1.5e20],
]).astype(np.float32)

# pair-CRF batches: ragged lengths in one bucket, lengths around 32 (and a
# second bucket), and rectangular shapes both ways
_rng = np.random.default_rng(3)
CRF_CASES = {
    "ragged": ([_rna(_rng, n) for n in (5, 17, 30, 24)],
               [_rna(_rng, n) for n in (29, 8, 21, 32)]),
    "around 32": ([_rna(_rng, n) for n in (1, 2, 31, 32, 33, 63)],
                  [_rna(_rng, n) for n in (33, 32, 31, 2, 1, 40)]),
    "32x96": ([_rna(_rng, n) for n in (20, 31, 9)], [_rna(_rng, n) for n in (80, 66, 96)]),
    "96x32": ([_rna(_rng, n) for n in (70, 90, 65)], [_rna(_rng, n) for n in (12, 30, 27)]),
}
# CONTRAfold: two buckets (32 and 64), free and constrained
_rng = np.random.default_rng(4)
CF_SEQS = [_rna(_rng, n) for n in (20, 31, 33, 50)]


def _constraint(seq, rng):
    """'.' at a few positions, two forced pairs (one of them maybe not
    complementary, which a forced pair keeps only when it was allowed)."""
    c = ["?"] * len(seq)
    for p in rng.choice(len(seq), 3, replace=False):
        c[p] = "."
    a, b = 1, len(seq) - 2
    c[a], c[b] = "(", ")"
    c[a + 1], c[b - 5] = "(", ")"
    return "".join(c)


CF_CONS = [_constraint(s, np.random.default_rng(i)) for i, s in enumerate(CF_SEQS)]

_JAX_REFERENCE = """
import json, sys
import numpy as np
from dafs_tpu.ops import contrafold, logspace, paircrf
args = json.loads(sys.stdin.read())
a = {k: np.asarray(v, np.float32) for k, v in args["grids"].items()}
out = {
    "lepo": np.asarray(logspace.contra_fast_logexpplusone(a["lepo_x"])),
    "fexp": np.asarray(logspace.contra_fast_exp(a["fexp_x"])),
    "lp": np.asarray(logspace.contra_fast_logplus(a["lp_x"], a["lp_y"])),
}
for name, (s1, s2) in args["crf"].items():
    for b, p in enumerate(paircrf.batch_posteriors(s1, s2, 0.0)):
        out[f"crf/{name}/{b}"] = p
for b, p in enumerate(contrafold.batch_bp_posteriors(args["cf"], 0.0)):
    out[f"cf/free/{b}"] = p
for b, p in enumerate(contrafold.batch_bp_posteriors(args["cf"], 0.0, constraints=args["cons"])):
    out[f"cf/con/{b}"] = p
np.savez(args["out"], **out)
"""


def _run_jax(script, args, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, "-c", script], input=json.dumps(args), text=True,
                   capture_output=True, cwd=ROOT, env=env, timeout=timeout, check=True)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    grids = dict(lepo_x=LEPO_X, fexp_x=FEXP_X, lp_x=LP_X, lp_y=LP_Y)
    _run_jax(_JAX_REFERENCE, dict(
        grids={k: v.tolist() for k, v in grids.items()}, crf=CRF_CASES,
        cf=CF_SEQS, cons=CF_CONS, out=path), timeout=900)
    return dict(np.load(path))


def _report(what, got, want):
    err = max(float(np.abs(np.float64(g) - np.float64(w)).max()) for g, w in zip(got, want))
    print(f"{what}: max |port - dafs_tpu| = {err!r}")
    return err


# ---------------------------------------------------------------- logspace --


def test_contra_logspace_matches_jax(jax_ref):
    """Dense grids through every piece boundary (and the float32 numbers
    beside each): the polynomials bit-equal; Fast_Exp's libm `exp` above 0
    within one rounding."""
    lepo = t_ls.contra_fast_logexpplusone(torch.from_numpy(LEPO_X)).numpy()
    np.testing.assert_array_equal(lepo, jax_ref["lepo"])
    lp = t_ls.contra_fast_logplus(torch.from_numpy(LP_X), torch.from_numpy(LP_Y)).numpy()
    np.testing.assert_array_equal(lp, jax_ref["lp"])
    fexp = t_ls.contra_fast_exp(torch.from_numpy(FEXP_X)).numpy()
    poly = FEXP_X <= 0
    np.testing.assert_array_equal(fexp[poly], jax_ref["fexp"][poly])
    np.testing.assert_allclose(fexp[~poly], jax_ref["fexp"][~poly], rtol=2.5e-7, atol=0)
    assert (fexp[FEXP_X < np.float32(-9.91152)] == 0).all()


# ------------------------------------------------------------------ tables --


def test_contralign_tables_bit_equal():
    want, got = j_cp.tables(), t_cp.tables()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(t_cp.encode("ACGUTNacgu"), j_cp.encode("ACGUTNacgu"))


def test_contrafold_tables_bit_equal():
    want, got = j_cfp.tables(), t_cfp.tables()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(t_cfp.COMPLEMENTARY, j_cfp.COMPLEMENTARY)
    assert np.array_equal(t_cfp.encode("ACGUTNacgu"), j_cfp.encode("ACGUTNacgu"))


# ---------------------------------------------------------------- pair-CRF --


@pytest.mark.parametrize("case", sorted(CRF_CASES))
def test_paircrf_matches_jax(case, jax_ref):
    s1, s2 = CRF_CASES[case]
    got = t_crf.batch_posteriors(s1, s2, 0.0, "cpu")
    want = [jax_ref[f"crf/{case}/{b}"] for b in range(len(s1))]
    for g, w, a, b in zip(got, want, s1, s2):
        assert g.shape == w.shape == (len(a), len(b))
    assert _report(f"pair-CRF {case}", got, want) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paircrf_matches_scalar_oracle(seed):
    rng = np.random.default_rng(seed)
    s1 = [_rna(rng, rng.integers(5, 18)) for _ in range(3)]
    s2 = [_rna(rng, rng.integers(5, 18)) for _ in range(3)]
    got = t_crf.batch_posteriors(s1, s2, 0.0, "cpu")
    for b in range(3):
        want = oracle_contralign.posterior(s1[b], s2[b])[1:, 1:]
        np.testing.assert_allclose(got[b], want, atol=5e-5, rtol=5e-4)


def test_paircrf_threshold_and_identity():
    s = "GGGAAACCCUUCGG"
    p = t_crf.batch_posteriors([s], [s], 0.0, "cpu")[0]
    assert np.diag(p).min() > 0.5 and p.max() <= 1.0
    cut = t_crf.batch_posteriors([s], [s], 0.01, "cpu")[0]
    assert np.array_equal(cut, np.where(p > np.float32(0.01), p, 0.0))


# -------------------------------------------------------------- CONTRAfold --


@pytest.mark.parametrize("kind", ["free", "con"])
def test_contrafold_matches_jax(kind, jax_ref):
    """Two buckets in one call, without and with constraints."""
    got = t_cf.batch_bp_posteriors(CF_SEQS, 0.0, "cpu",
                                   constraints=CF_CONS if kind == "con" else None)
    want = [jax_ref[f"cf/{kind}/{b}"] for b in range(len(CF_SEQS))]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert _report(f"CONTRAfold {kind}", got, want) <= 1e-5
    assert max(float(w.max()) for w in want) > 0.5


def test_constraints_bite():
    free = t_cf.batch_bp_posteriors(CF_SEQS, 0.0, "cpu")
    con = t_cf.batch_bp_posteriors(CF_SEQS, 0.0, "cpu", constraints=CF_CONS)
    for f, c, cs in zip(free, con, CF_CONS):
        dots = [k for k, ch in enumerate(cs) if ch == "."]
        assert not c[dots, :].any() and not c[:, dots].any()
        assert np.abs(f - c).max() > 1e-3


@pytest.mark.parametrize("seq", ["GGGAAACCC", "GCAUCGGC", "AUGGCAAUGC", "CCGGAAUU"])
def test_contrafold_matches_enumeration(seq):
    got = t_cf.batch_bp_posteriors([seq], 0.0, "cpu")[0]
    np.testing.assert_allclose(got, oracle_contrafold.exact_bpp(seq), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("seq,con", [
    ("GGGAAACCC", "((?????))"),
    ("GGGAAACCC", "??..?????"),
    ("GCAUCGAUGC", "(????????)"),
    ("GGCGAAACGCC", "?.?????????"),
])
def test_constrained_contrafold_matches_enumeration(seq, con):
    got = t_cf.batch_bp_posteriors([seq], 0.0, "cpu", constraints=[con])[0]
    np.testing.assert_allclose(got, np.float32(_constrained_exact_bpp(seq, con)),
                               rtol=5e-5, atol=5e-6)
    got1 = t_cf.batch_bp_posteriors([seq], 0.0, "cpu", constraints=["(" + "?" * (len(seq) - 2) + ")"])[0]
    if seq[0] + seq[-1] in ("GC", "CG", "AU", "UA", "GU", "UG"):
        assert got1[0, -1] == pytest.approx(1.0, abs=1e-6)


def test_contrafold_trna_snapshot():
    """Sequences 0 and 7 of RF00005 at full length (L = 72, 73) against the
    JAX package's snapshot: the 61-row single-branch window and the FM2
    outside accumulators at real split sizes."""
    snap = np.load(os.path.join(ROOT, "tests", "snapshots", "contrafold_trna.npz"))
    fa = load_fasta(os.path.join(DATA, "RF00005_0.fa"))
    assert fa[0].seq == str(snap["s0"]) and fa[7].seq == str(snap["s1"])
    got = t_cf.batch_bp_posteriors([fa[0].seq, fa[7].seq], 0.0, "cpu")
    _report("CONTRAfold tRNA snapshot", got, [snap["p0"], snap["p1"]])
    np.testing.assert_allclose(got[0], snap["p0"], atol=5e-5)
    np.testing.assert_allclose(got[1], snap["p1"], atol=5e-5)


_JAX_RF00017 = """
import json, sys
import numpy as np
from dafs_tpu.ops import contrafold
args = json.loads(sys.stdin.read())
np.savez(args["out"], *contrafold.batch_bp_posteriors(args["seqs"], 0.0))
"""


@pytest.mark.slow
def test_contrafold_matches_jax_at_rf00017_size(tmp_path):
    """Two SRP RNAs of RF00017 (bucket 320): the outside accumulators at the
    main path's widest fold.  Held at the snapshot's 5e-5: log Z is four
    times the tRNAs' here, and one float32 rounding of it moves a
    posterior by about 3e-5 of itself."""
    fa = load_fasta(os.path.join(DATA, "RF00017_4.fa"))
    seqs = [fa[0].seq, fa[5].seq]
    path = str(tmp_path / "ref.npz")
    _run_jax(_JAX_RF00017, dict(seqs=seqs, out=path), timeout=1800)
    want = list(np.load(path).values())
    got = t_cf.batch_bp_posteriors(seqs, 0.0, "cpu")
    assert all(-(-len(s) // 32) * 32 == 320 for s in seqs)
    assert _report("CONTRAfold RF00017", got, want) <= 5e-5
