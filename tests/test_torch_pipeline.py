"""The port's whole slice against `dafs_tpu`, its entry points, and its
independence from JAX.

The references are the JAX package's default path, `dafs_tpu.pipeline.Dafs(
ProbCons(0.01), RNAfold(True, CUTOFF), Options(), alifold_model=Alifold(0.0,
bl=True))`, the same without any consensus mix (`Options(use_alifold=False),
alifold_model=None`), the JAX CLI's `--no-alifold` and model and
bp-update options (`CLI_OPTIONS`), and its refinement, four-way PCT, DD
update and parameter-file options on every family (`FAMILY_OPTIONS`).
They run in one
subprocess with XLA's CPU code generation capped below FMA
(`--xla_cpu_max_isa=AVX`): by default XLA on the CPU contracts
multiply-adds into fused multiply-adds, which the port (like the TPU) never
does, and on the seeded family below that one rounding difference moves a
DD trajectory and one gap.  Without it, tree topology, SS_cons and the
gapped rows must be identical and the tree scores agree within 1e-4.  The
JAX package keeps its consensus pf-scale warm start in a module global, so
the reference clears it before each run, as a fresh process would start.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dafs_tpu_torch
from dafs_tpu_torch import cli, pipeline
from dafs_tpu_torch.fasta import Fasta, load_fasta
from dafs_tpu_torch.models import align_models, fold_models
from dafs_tpu_torch.typedefs import CUTOFF

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

TINY = [("a", "GGGCGCAAGCCU"), ("b", "GGGCGCUUGCCU"), ("c", "GGACGCAAGCCU")]


def _seeded_family(seed=1, n=5):
    """n mutated copies of one random 52-nt sequence (lengths 40-64)."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGU"), size=52))
    out = []
    for k in range(n):
        s = list(base)
        for _ in range(int(rng.integers(3, 9))):
            pos = int(rng.integers(0, len(s)))
            op = rng.integers(0, 3)
            if op == 0:
                s[pos] = rng.choice(list("ACGU"))
            elif op == 1 and len(s) > 40:
                del s[pos]
            elif len(s) < 64:
                s.insert(pos, rng.choice(list("ACGU")))
        out.append((f"s{k}", "".join(s)))
    return out


FAMILIES = {"three_hairpins": TINY, "seeded_5x52": _seeded_family()}
TINY_RECORDS = [Fasta(n, s) for n, s in TINY]

_JAX_REFERENCE = """
import contextlib, io, json, sys
from dafs_tpu import cli, pipeline
from dafs_tpu.fasta import Fasta
from dafs_tpu.models import align_models, fold_models
from dafs_tpu.ops import alifold
from dafs_tpu.parallel.mesh import force_single_device
args = json.loads(sys.stdin.read())
out = {"plain": {}, "default": {}}
for name, recs in args["families"].items():
    for kind, opts, ali in (("plain", pipeline.Options(use_alifold=False), None),
                            ("default", pipeline.Options(), alifold.Alifold(0.0, bl=True))):
        alifold._SC_CACHE.clear()
        with force_single_device():
            d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(True, 0.01),
                              opts, alifold_model=ali)
            d.run([Fasta(n, s) for n, s in recs])
        out[kind][name] = d.result
out["cli"] = {}
for flags in args["cli_options"]:
    alifold._SC_CACHE.clear()
    buf = io.StringIO()
    with force_single_device(), contextlib.redirect_stdout(buf):
        cli.main([*flags, args["tiny_fa"]])
    out["cli"][" ".join(flags)] = buf.getvalue()
# -P last: its override is a process global
out["family_cli"] = {}
for flags in args["family_options"]:
    for name, path in args["family_fa"].items():
        alifold._SC_CACHE.clear()
        buf = io.StringIO()
        with force_single_device(), contextlib.redirect_stdout(buf):
            cli.main([*flags, path])
        out["family_cli"][" ".join(flags) + " " + name] = buf.getvalue()
print(json.dumps(out))
"""

# options that run on the tiny family through both CLIs (the API cases
# below are held to the same JAX CLI runs)
CLI_OPTIONS = [["-a", "CONTRAlign"], ["-s", "CONTRAfold"], ["-s", "Vienna"],
               ["--bp-update"], ["--bp-update1"]]

# options that run on every family of FAMILIES through both CLIs; `-P` comes
# last, since its override stays for the rest of a process
PAR_FILE = os.path.join(ROOT, "tests", "data", "ml_ninio.par")
FAMILY_OPTIONS = [["-r", "2"], ["-r", "1", "-m", "0"], ["-f", "0.5"],
                  ["--dd-update", "adagrad"], ["--dd-update", "adam"], ["-P", PAR_FILE]]


@pytest.fixture(scope="module")
def family_fa(tmp_path_factory):
    """One FASTA file per family of FAMILIES."""
    d = tmp_path_factory.mktemp("families")
    out = {}
    for name, recs in FAMILIES.items():
        out[name] = str(d / f"{name}.fa")
        with open(out[name], "w") as fh:
            fh.write("".join(f">{n}\n{s}\n" for n, s in recs))
    return out


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory, family_fa):
    tiny = tmp_path_factory.mktemp("fa") / "tiny.fa"
    tiny.write_text("".join(f">{n}\n{s}\n" for n, s in TINY))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    # two processes side by side: the families and the tiny family's
    # options, and FAMILY_OPTIONS
    jobs = [dict(families=FAMILIES, cli_options=[["--no-alifold"]] + CLI_OPTIONS,
                 family_options=[]),
            dict(families={}, cli_options=[], family_options=FAMILY_OPTIONS)]
    procs = []
    for k, job in enumerate(jobs):
        args = tiny.parent / f"job{k}.json"
        args.write_text(json.dumps(dict(job, tiny_fa=str(tiny), family_fa=family_fa)))
        with open(args) as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_REFERENCE], stdin=fh, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env))
    out = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stderr
        for key, runs in json.loads(stdout.strip().splitlines()[-1]).items():
            out.setdefault(key, {}).update(runs)
    return out, str(tiny)


def _assert_same_result(got, want):
    assert NUM.sub("#", got.tree) == NUM.sub("#", want["tree"])
    for a, b in zip(NUM.findall(got.tree), NUM.findall(want["tree"])):
        assert abs(float(a) - float(b)) <= 1e-4
    assert got.ss_cons == want["ss_cons"]
    assert got.names == want["names"]
    assert got.rows == want["rows"]
    assert abs(got.score - want["score"]) <= 1e-4


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_slice_matches_jax(family, jax_reference):
    """No consensus mix anywhere: `Dafs(..., alifold_model=None)`."""
    d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(True, CUTOFF),
                      pipeline.Options(use_alifold=False), alifold_model=None, device="cpu")
    d.run([Fasta(n, s) for n, s in FAMILIES[family]])
    _assert_same_result(dafs_tpu_torch.Result(**d.result), jax_reference[0]["plain"][family])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_default_path_matches_jax(family, jax_reference):
    """DAFS's default path: the consensus mixed into every merge and the
    final structure."""
    got = dafs_tpu_torch.align_and_fold(
        [Fasta(n, s) for n, s in FAMILIES[family]], device="cpu"
    )
    assert got.consensus_calls
    _assert_same_result(got, jax_reference[0]["default"][family])


def test_no_alifold_cli_matches_jax_cli(jax_reference, capsys):
    """`--no-alifold` drops the mix from the merges only; the final
    structure mixes it in, as in the JAX CLI."""
    want, tiny = jax_reference
    assert cli.main(["--no-alifold", "--device", "cpu", tiny]) == 0
    assert capsys.readouterr().out == want["cli"]["--no-alifold"]


@pytest.mark.parametrize("flags,kw", [(f, None) for f in CLI_OPTIONS] + [
    (["-a", "CONTRAlign"], dict(align_model="CONTRAlign")),
    (["-s", "CONTRAfold"], dict(fold_model="CONTRAfold")),
])
def test_options_match_jax_cli(flags, kw, jax_reference, capsys):
    """Each model and bp-update option runs on the tiny family through the
    port's CLI (or, with `kw`, its API) and prints the JAX CLI's bytes."""
    want, tiny = jax_reference
    if kw is None:
        assert cli.main([*flags, "--device", "cpu", tiny]) == 0
        got = capsys.readouterr().out
    else:
        got = str(dafs_tpu_torch.align_and_fold(tiny, device="cpu", **kw))
    _assert_valid_output(got)
    assert got == want["cli"][" ".join(flags)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("flags", FAMILY_OPTIONS,
                         ids=lambda f: " ".join(os.path.basename(a) for a in f))
def test_family_options_match_jax_cli(flags, family, jax_reference, family_fa, capsys):
    """Refinement (with the device DD and with the exact ILP), four-way PCT,
    the adagrad and adam DD updates and a parameter file print the JAX
    CLI's bytes on each family."""
    from dafs_tpu_torch.ops import energy_params

    want, _ = jax_reference
    try:
        assert cli.main([*flags, "--device", "cpu", family_fa[family]]) == 0
    finally:
        energy_params.set_param_overrides({})
    got = capsys.readouterr().out
    assert got == want["family_cli"][" ".join(flags) + " " + family]


def test_api_vienna_equals_cli(tiny_fa, capsys):
    """`fold_model="Vienna"` folds and forms the consensus with Vienna's
    parameters (bl=False), as the CLI's `-s Vienna` does."""
    assert cli.main(["-s", "Vienna", "--device", "cpu", tiny_fa]) == 0
    res = dafs_tpu_torch.align_and_fold(tiny_fa, device="cpu", fold_model="Vienna")
    assert str(res) == capsys.readouterr().out
    from dafs_tpu_torch.ops import alifold

    d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(False, CUTOFF),
                      pipeline.Options(), alifold_model=alifold.Alifold(0.0, bl=False),
                      device="cpu")
    d.run(load_fasta(tiny_fa))
    assert d.result["ss_cons"] == res.ss_cons and d.result["rows"] == res.rows
    # both models under Vienna's parameters: leaf groups come from the fold stage
    assert [c["route"] for c in res.consensus_calls].count("fold stage") == len(TINY)


def test_fold_model_without_bl_runs():
    """A fold model that is not McCaskill (CONTRAfold has no `bl`): its leaf
    groups run the consensus's own McCaskill."""
    from dafs_tpu_torch.ops import alifold

    d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.CONTRAfold(CUTOFF),
                      pipeline.Options(), alifold_model=alifold.Alifold(0.0, bl=False),
                      device="cpu")
    d.run([Fasta(n, s) for n, s in TINY])
    routes = [c["route"] for c in d.result["consensus_calls"]]
    assert routes.count("mccaskill") == len(TINY) and "fold stage" not in routes
    assert len(d.result["ss_cons"]) == len(d.result["rows"][0])


@pytest.mark.parametrize("kw", [
    {},
    dict(align_model="CONTRAlign", fold_model="CONTRAfold"),
    dict(use_bp_update=True, use_bp_update1=True),
    dict(fold_decoder="IPknot", th_s=(0.2, 1 / 9.0), th_s1=(1 / 3.0, 0.2), use_bp_update1=True),
    dict(t_max=0),
    dict(n_refinement=1, w_pct_f=0.5, dd_update="adam", param_file=PAR_FILE),
])
def test_port_runs_without_jax(kw):
    """The default path, path (a) (CONTRAlign, CONTRAfold), path (b)
    (bp-update), `--ipknot`, `-m 0`, and refinement with four-way PCT, the
    adam DD update and a parameter file, with `jax` blocked and the
    multi-device modules (`parallel.mesh`, `multiproc`, `dryrun`) imported:
    nothing of JAX or `dafs_tpu` loads."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import dafs_tpu_torch\n"
        "import dafs_tpu_torch.parallel.dryrun, dafs_tpu_torch.parallel.mesh\n"
        "import dafs_tpu_torch.parallel.multiproc\n"
        f"res = dafs_tpu_torch.align_and_fold({[s for _, s in TINY]!r}, device='cpu', **{kw!r})\n"
        "assert not [m for m in sys.modules if m == 'dafs_tpu' or m.startswith('dafs_tpu.')]\n"
        "assert [c for c in res.consensus_calls if c['route'] == 'alifold']\n"
        "print(res.ss_cons)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.fullmatch(r"[().\[\]]+", proc.stdout.strip())


@pytest.fixture
def tiny_fa(tmp_path):
    p = tmp_path / "tiny.fa"
    p.write_text("".join(f">{n}\n{s}\n" for n, s in TINY))
    return str(p)


def _assert_valid_output(out):
    lines = out.splitlines()
    assert re.fullmatch(r"\[ .* \]", lines[0]) and lines[1] == ">SS_cons"
    assert [l[2:] for l in lines[3::2]] == ["a", "b", "c"]
    assert all(r.replace("-", "") == s for r, (_, s) in zip(lines[4::2], TINY))
    sstr = lines[2]
    assert re.fullmatch(r"[().]+", sstr) and all(len(r) == len(sstr) for r in lines[4::2])
    depth = 0
    for ch in sstr:
        depth += {"(": 1, ")": -1}.get(ch, 0)
        assert depth >= 0
    assert depth == 0


def test_cli_matches_api(tiny_fa, capsys):
    assert cli.main(["--no-alifold", "--device", "cpu", tiny_fa]) == 0
    out = capsys.readouterr().out
    res = dafs_tpu_torch.align_and_fold(tiny_fa, device="cpu", use_alifold=False)
    assert out == str(res)
    _assert_valid_output(out)


def test_cli_without_flags_runs(tiny_fa, capsys):
    """The CLI without options runs the default path, consensus mix on."""
    assert cli.main(["--device", "cpu", tiny_fa]) == 0
    out = capsys.readouterr().out
    _assert_valid_output(out)
    assert out == str(dafs_tpu_torch.align_and_fold(tiny_fa, device="cpu"))


@pytest.fixture(scope="module")
def saved_aux(tmp_path_factory):
    """The aux files of one `--save-align-aux --save-fold-aux` run of the
    port's CLI on the tiny family."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("aux")
    fa = d / "tiny.fa"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in TINY))
    files = {"mp.txt": str(d / "mp.txt"), "bp.txt": str(d / "bp.txt")}
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--save-align-aux", files["mp.txt"], "--save-fold-aux",
                         files["bp.txt"], "--device", "cpu", str(fa)]) == 0
    return files


@pytest.mark.parametrize("argv", [
    ["-r", "1"],
    ["-f", "0.5"],
    ["--align-aux", "mp.txt"],
    ["--fold-aux", "bp.txt"],
    ["--save-align-aux", "mp.txt"],
    ["-P", "ml_ninio.par"],
    ["--dd-update", "adam"],
    ["--dd-update", "adagrad"],
])
def test_slice_options_run(argv, tiny_fa, saved_aux, tmp_path, capsys):
    """The options that raised before they were ported run through the CLI
    and print a valid output; the aux inputs read the files a `--save-*`
    run wrote (their bytes against the JAX CLI are held in
    tests/test_torch_options.py)."""
    from dafs_tpu_torch.ops import energy_params

    flag, name = argv
    path = {"--align-aux": saved_aux.get(name), "--fold-aux": saved_aux.get(name),
            "--save-align-aux": str(tmp_path / name), "-P": PAR_FILE}.get(flag, name)
    try:
        assert cli.main([flag, path, "--device", "cpu", tiny_fa]) == 0
    finally:
        energy_params.set_param_overrides({})
    _assert_valid_output(capsys.readouterr().out)
    if flag == "--save-align-aux":
        assert open(path).read().startswith("> 1 2\n1 1:")


@pytest.mark.parametrize("argv", [
    ["--ipknot"],
    ["--fold-decoder", "IPknot"],
    ["-m", "0"],
    ["-v", "2"],
])
def test_host_solver_options_run(argv, tiny_fa, capsys):
    """The host merge solvers' options, which raised before they were
    ported, run through the CLI (their bytes against the JAX CLI are held
    in tests/test_torch_solvers.py)."""
    assert cli.main([*argv, "--device", "cpu", tiny_fa]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert ">SS_cons" in lines and [l for l in lines if l.startswith("> ")][-3:] == [
        "> a", "> b", "> c"]


@pytest.mark.parametrize("kw,flags", [(dict(n_refinement=2), "-r 2"),
                                      (dict(dd_update="adam"), "--dd-update adam")])
def test_api_slice_options_run(kw, flags, jax_reference):
    """Refinement and the adam DD update through the API print the JAX
    CLI's bytes of the same options."""
    got = dafs_tpu_torch.align_and_fold(TINY_RECORDS, device="cpu", **kw)
    _assert_valid_output(str(got))
    assert str(got) == jax_reference[0]["family_cli"][flags + " three_hairpins"]


def test_api_use_alifold_true_equals_default():
    seqs = [s for _, s in TINY]
    on = dafs_tpu_torch.align_and_fold(seqs, device="cpu", use_alifold=True)
    default = dafs_tpu_torch.align_and_fold(seqs, device="cpu")
    assert str(on) == str(default) and on.score == default.score
    assert [c["route"] for c in on.consensus_calls] == [c["route"] for c in default.consensus_calls]


@pytest.mark.parametrize("fold_bl", [True, False])
def test_dafs_reused_reports_each_run(fold_bl):
    """A `Dafs` run twice reports each run's consensus calls only, and
    serves leaf groups from the fold stage only under the consensus's own
    parameter set."""
    from dafs_tpu_torch.ops import alifold

    d = pipeline.Dafs(align_models.ProbCons(0.01), fold_models.RNAfold(fold_bl, CUTOFF),
                      pipeline.Options(), alifold_model=alifold.Alifold(0.0, bl=True),
                      device="cpu")
    runs = []
    for recs in (TINY, TINY[:2]):
        d.run([Fasta(n, s) for n, s in recs])
        runs.append([c["route"] for c in d.result["consensus_calls"]])
    leaf = "fold stage" if fold_bl else "mccaskill"
    assert runs[0].count(leaf) == 3 and runs[1].count(leaf) == 2
    assert len(d.alifold.calls) == len(runs[0]) + len(runs[1])


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        dafs_tpu_torch.align_and_fold([s for _, s in TINY])


def test_single_sequence():
    res = dafs_tpu_torch.align_and_fold(["GGGCGCAAGCCU"], names=["a"], device="cpu")
    assert res.tree == "a" and res.rows == ["GGGCGCAAGCCU"]
    assert res.ss_cons.count("(") == res.ss_cons.count(")")
