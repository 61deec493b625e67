"""What the card tests (`tests/test_torch_cuda.py`, marker `cuda`) and
`chip_smoke.py` share: the inputs at the main path's shapes and the
instrumentation of the fold's ladder and the DD step, the launch rules
that every run on the card is held to, the run table `RUNS` and how each
kind of row runs, and the comparisons of the fold, consensus and DD step
kernels with their plain versions on the card.  Imports nothing of JAX;
everything here but the inputs and the row type needs a card."""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SNAP = os.path.join(ROOT, "tests", "snapshots")
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
T_MAX = 600  # the DD iteration cap of every run in the table
PAR_FILE = os.path.join(DATA, "ml_ninio.par")

PAIRHMM = ("pairhmm_forward", "pairhmm_backward", "pairhmm_posterior")
DECODERS = ("nussinov", "nw")
CONSENSUS = ("alifold_inside", "alifold_exterior", "alifold_outside")
FOLD = ("mccaskill_inside", "mccaskill_exterior", "mccaskill_outside")
DD_STEP = ("dd_candidates", "dd_update", "dd_scalars")
PAIRCRF = ("paircrf_forward", "paircrf_backward", "paircrf_posterior")
LONG = ("pairhmm_forward_long", "pairhmm_backward_long", "nussinov_long", "nw_long")
MAIN = PAIRHMM + DECODERS + CONSENSUS + FOLD + DD_STEP  # every one runs on the default path


# ------------------------------------------------------------ the inputs --


def read_fasta(name):
    from dafs_tpu_torch.fasta import load_fasta

    return load_fasta(os.path.join(DATA, name))


def read_snapshot(name):
    """(tree, SS_cons, names, rows) of a recorded output."""
    with open(os.path.join(SNAP, name)) as fh:
        lines = fh.read().splitlines()
    return lines[0].strip(), lines[2], [l[2:] for l in lines[3::2]], lines[4::2]


def family50():
    """The 50-sequence all-pairs family of `bench.py`, from RF00005."""
    from dafs_tpu_torch.fasta import Fasta
    from dafs_tpu_torch.parallel import dryrun

    seqs = dryrun.mutated_family([f.seq for f in read_fasta("RF00005_0.fa")])
    return [Fasta(f"fam{i}", s) for i, s in enumerate(seqs)]


def refold_constraints(snap_name):
    """Path (b)'s constrained re-folds of a family: each sequence's
    constraint from the snapshot's SS_cons projected onto its row ('(' ')'
    where both ends are bases, '?' elsewhere), as `pipeline._update_bp`
    builds them; returns (seqs, constraints)."""
    _, ss, _, rows = read_snapshot(snap_name)
    stack, pairs = [], []
    for k, ch in enumerate(ss):
        if ch == "(":
            stack.append(k)
        elif ch == ")":
            pairs.append((stack.pop(), k))
    seqs, cons = [], []
    for row in rows:
        pos = np.cumsum([c != "-" for c in row]) - 1
        seq = row.replace("-", "")
        con = ["?"] * len(seq)
        for a, b in pairs:
            if row[a] != "-" and row[b] != "-":
                con[pos[a]], con[pos[b]] = "(", ")"
        seqs.append(seq)
        cons.append("".join(con))
    return seqs, cons


def pairhmm_inputs(fa, dev):
    from dafs_tpu_torch.ops import pairhmm

    seqs = [f.seq for f in fa]
    pairs = [(i, j) for i in range(len(seqs)) for j in range(i + 1, len(seqs))]
    lmax = -(-max(len(s) for s in seqs) // 32) * 32
    c1, n1 = pairhmm.encode_batch([seqs[i] for i, _ in pairs], lmax)
    c2, n2 = pairhmm.encode_batch([seqs[j] for _, j in pairs], lmax)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


def random_pairs(rng, lens1, lens2, l1max, l2max, dev):
    """Pair-HMM inputs for random sequences of these true lengths."""
    from dafs_tpu_torch.ops import pairhmm

    def seqs(lens):
        return ["".join(rng.choice(list("ACGU"), size=int(n))) for n in lens]
    c1, n1 = pairhmm.encode_batch(seqs(lens1), l1max)
    c2, n2 = pairhmm.encode_batch(seqs(lens2), l2max)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


def ragged_lens(rng, B, L, short):
    """True lengths near L, the last `short` of them 0, 1, 2, ... (a DD
    batch holds problems of many lengths)."""
    lens = rng.integers(L - 40, L + 1, size=B).astype(np.int32)
    lens[B - short:] = np.arange(short) % 6
    return lens


def quarter_steps(rng, shape):
    """Scores in quarter steps, zeros half of them -0.0: exact sums, so
    every max and every tie-break is exercised."""
    sm = (rng.integers(-4, 5, size=shape) / 4).astype(np.float32)
    neg0 = (sm == 0) & (rng.random(shape) < 0.5)
    sm[neg0] = np.float32(-0.0)
    return sm


def nussinov_inputs(rng, B, L, dev, short=0):
    lens = ragged_lens(rng, B, L, short)
    sm = np.full((B, L, L), np.float32(-0.8), np.float32)
    for b in range(B):
        n = int(lens[b])
        if n < 4:
            continue
        p = np.zeros((n, n), np.float32)
        for _ in range(int(rng.integers(n, 3 * n))):
            i = int(rng.integers(0, n - 3))
            j = int(rng.integers(i + 3, n))
            p[i, j] = rng.random()
        q = (rng.random((n, n)) * 0.2).astype(np.float32)
        sm[b, :n, :n] = np.float32(np.float32(4.0) * (p - np.float32(0.2)) - q)
    return torch.from_numpy(sm).to(dev), torch.from_numpy(lens).to(dev)


def nw_inputs(rng, B, L1, L2, dev, short=0, ties=False):
    """Banded NW problems; `ties`: quarter-step posteriors with -0.0 among
    the scores, so M/X/Y ties are frequent."""
    from dafs_tpu_torch.ops import nw

    th = np.float32(0.25 if ties else 0.01)
    sm = np.full((B, L1, L2), -th, np.float32)
    envf = np.zeros((B, L1 + 1), np.int32)
    envl = np.full((B, L1 + 1), L2, np.int32)
    l1 = ragged_lens(rng, B, L1, short)
    l2 = rng.integers(L2 - 40, L2 + 1, size=B).astype(np.int32)
    for b in range(B):
        n1, n2 = int(l1[b]), int(l2[b])
        if ties:
            p = np.abs(quarter_steps(rng, (n1, n2))) * (rng.random((n1, n2)) < 0.3)
            q = np.abs(quarter_steps(rng, (n1, n2))) / 2
            s = np.float32(p - th + q)
            s[rng.random((n1, n2)) < 0.05] = np.float32(-0.0)
        else:
            p = np.zeros((n1, n2), np.float32)
            for i in range(n1):
                j = int(np.clip(round(i * n2 / n1 + rng.integers(-3, 4)), 0, n2 - 1))
                p[i, j] = 0.3 + 0.7 * rng.random()
                if rng.random() < 0.3:
                    p[i, int(rng.integers(0, n2))] += 0.2
            q = (rng.random((n1, n2)) * 0.1).astype(np.float32)
            s = np.float32(p - th + q)
        env = nw.envelope(p, th)
        sm[b, :n1, :n2] = s
        envf[b, : n1 + 1] = env[:, 0]
        envl[b, : n1 + 1] = env[:, 1]
    return [torch.from_numpy(a).to(dev) for a in (sm, envf, envl, l1, l2)]


def paircrf_inputs(seqs1, seqs2, dev, l1max=None, l2max=None):
    """The pair-CRF's inputs as `paircrf.batch_posteriors` builds them, at
    the 32-buckets of the longest sequences unless given."""
    from dafs_tpu_torch.ops import paircrf

    l1max = l1max or -(-max(map(len, seqs1)) // 32) * 32
    l2max = l2max or -(-max(map(len, seqs2)) // 32) * 32
    c1, n1 = paircrf.encode_batch(seqs1, l1max)
    c2, n2 = paircrf.encode_batch(seqs2, l2max)
    return [torch.from_numpy(a).to(dev) for a in (c1, n1, c2, n2)]


def stable_scale(args, n, bsn0, BCUT):
    """A per-column scale at which Q lies near 1, found with the kernels (Q
    scales as sc ** n).  Past n of about 520 one step of the pf-scale
    ladder (0.8 or 1.25 a column) moves Q by more than the ladder's window
    of 1e-25 to 1e25, so a long alignment starts from here."""
    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    sc = np.float32(alifold.SC0)
    for _ in range(40):
        _, Q = alifold_cuda.inside_outside(ak.prepare(*args, n, sc, bsn0), n, BCUT=BCUT)
        q = float(Q)
        if np.isfinite(q) and 1e-5 < q < 1e5:
            return sc
        if np.isfinite(q) and q > 1e-30:
            sc = np.float32(sc * (1.0 / q) ** (1.0 / n))
        else:
            sc = np.float32(sc * 10.0 ** ((-30.0 if not np.isfinite(q) else 30.0) / n))
    raise AssertionError(f"consensus n {n}: no scale with Q near 1")


def traced_fold(seqs, dev, bl, cons, sc0, plain):
    """`mccaskill.batch_bp_posteriors_fast` on the card with every ladder
    attempt traced (each row's scale, and what the ladder reads: good,
    over), its attempts run by the plain version (`plain`) or by the
    kernels.  sc0: each row's first scale (the ladder's exp(-0.6) if None):
    every attempt's scales are the ladder's times sc0 / exp(-0.6).  Returns
    (posteriors, trace, the last attempt: pout, Q, sc, the bucket's
    arguments and tables, and for the plain version its qb, q1 and qn)."""
    from dafs_tpu_torch.ops import mccaskill
    from dafs_tpu_torch.ops import mccaskill_kernel as MK

    real = mccaskill.fold_attempt
    trace, last = [], {}
    ratio = None if sc0 is None else torch.from_numpy(
        np.asarray(sc0, np.float32) / np.float32(np.exp(-0.6)))

    def attempt(args, sc, codes, tabs, prep=None):
        if ratio is not None:
            sc = sc * ratio.to(sc.device)
        if plain:
            pout, Q, last["parts"] = MK.mccaskill_fast(*args, sc, codes, tabs, parts=True)
        else:
            pout, Q = real(args, sc, codes, tabs, prep)
        Qv = Q.cpu().numpy()
        fin = torch.isfinite(pout).all(dim=2).all(dim=1).cpu().numpy()
        good = np.isfinite(Qv) & (Qv > 1e-25) & (Qv < 1e25) & fin
        over = ~np.isfinite(Qv) | (Qv >= 1e25)
        trace.append((sc.cpu().numpy().tolist(), good.tolist(), over.tolist()))
        last.update(pout=pout, Q=Q, sc=sc, args=args, codes=codes, tabs=tabs, prep=prep)
        return pout, Q

    mccaskill.fold_attempt = attempt
    try:
        out = mccaskill.batch_bp_posteriors_fast(seqs, 0.0, dev, bl=bl, constraints=cons)
    finally:
        mccaskill.fold_attempt = real
    return out, trace, last


def fold_stable_scale(seqs, dev, bl=True):
    """Per-row scales at which Q lies near 1, found with the kernels (Q
    scales as sc ** n): past n of about 520 one ladder step moves Q by more
    than the ladder's window, so a long sequence starts from here."""
    from dafs_tpu_torch import params
    from dafs_tpu_torch.ops import mccaskill, mccaskill_cuda

    L = mccaskill._round_up(max(len(s) for s in seqs), 32)
    S, PT, AP, AU, ns = mccaskill.bucket_inputs(seqs, L, len(seqs))
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    prep = mccaskill_cuda.prepare(t(S), t(PT), t(AP), t(AU), t(ns), mccaskill.kmer_codes(t(S)),
                                  params.to_device(mccaskill._fast_tabs(bl), dev))
    sc = np.full(len(seqs), np.exp(-0.6), np.float32)
    for _ in range(40):
        q = mccaskill_cuda.mccaskill(prep, t(sc))[1].cpu().numpy().astype(np.float64)
        ok = np.isfinite(q) & (q > 1e-5) & (q < 1e5)
        if ok.all():
            return sc
        step = np.where(np.isfinite(q) & (q > 1e-30), (1.0 / np.maximum(q, 1e-300)) ** (1.0 / ns),
                        10.0 ** (np.where(np.isfinite(q), 30.0, -30.0) / ns))
        sc = np.where(ok, sc, (sc * step).astype(np.float32)).astype(np.float32)
    raise AssertionError("fold: no scale with Q near 1")


@contextlib.contextmanager
def plain_dd_step():
    """Inside the block, DD loops on the card take the plain step
    (`dd._step_plain` and the plain score matrices, ATen on the card) in
    place of the step kernels."""
    from dafs_tpu_torch.ops import dd_step_cuda

    orig, dd_step_cuda.Step = dd_step_cuda.Step, lambda pr, st: None
    try:
        yield
    finally:
        dd_step_cuda.Step = orig


def dd_layers(fa, dev, **kw):
    """The batched DD of every guide-tree layer of one `align_and_fold` run
    on `dev`: [(problems, solver keywords)], in the order solved."""
    from dafs_tpu_torch import align_and_fold, dd

    layers = []
    orig = dd.solve_by_dd_batch

    def solve(problems, **solve_kw):
        layers.append((problems, {k: v for k, v in solve_kw.items() if k != "stats"}))
        return orig(problems, **solve_kw)

    dd.solve_by_dd_batch = solve
    try:
        align_and_fold(fa, device=dev, **kw)
    finally:
        dd.solve_by_dd_batch = orig
    return layers


def dd_state(problems, kw, rule, plain=False):
    """(prep_batch's tensors, a `dd._State`) of one layer on kw["device"]
    under `rule`, with the step kernels or (plain) the plain step."""
    from dafs_tpu_torch import dd

    pr = dd.prep_batch(problems, w=kw["w"], th_s=kw["th_s"], th_a=kw["th_a"],
                       device=kw["device"])
    f = np.float32
    core = dict(th_s0=float(f(kw["th_s"][0])), th_a=float(f(kw["th_a"])),
                eta0=float(f(kw["eta0"])), t_max=kw["t_max"], update_rule=rule)
    if plain:
        with plain_dd_step():
            return pr, dd._State(pr, **core)
    return pr, dd._State(pr, **core)


# ------------------------------------------------------ launch counting --


def kernels():
    """{name: CudaKernel} of every kernel whose launches a run counts."""
    from dafs_tpu_torch.ops import (alifold_cuda, dd_step_cuda, mccaskill_cuda, nussinov_cuda,
                                    nw_cuda, paircrf_cuda, pairhmm_cuda)

    return {
        "pairhmm_forward": pairhmm_cuda.FORWARD, "pairhmm_backward": pairhmm_cuda.BACKWARD,
        "pairhmm_posterior": pairhmm_cuda.POSTERIOR,
        "nussinov": nussinov_cuda.DECODE, "nw": nw_cuda.DECODE,
        "alifold_inside": alifold_cuda.INSIDE, "alifold_exterior": alifold_cuda.EXTERIOR,
        "alifold_outside": alifold_cuda.OUTSIDE,
        "mccaskill_inside": mccaskill_cuda.INSIDE, "mccaskill_exterior": mccaskill_cuda.EXTERIOR,
        "mccaskill_outside": mccaskill_cuda.OUTSIDE,
        "dd_candidates": dd_step_cuda.CANDIDATES, "dd_update": dd_step_cuda.UPDATE,
        "dd_scalars": dd_step_cuda.SCALARS,
        "paircrf_forward": paircrf_cuda.FORWARD, "paircrf_backward": paircrf_cuda.BACKWARD,
        "paircrf_posterior": paircrf_cuda.POSTERIOR,
        "pairhmm_forward_long": pairhmm_cuda.FORWARD_LONG,
        "pairhmm_backward_long": pairhmm_cuda.BACKWARD_LONG,
        "nussinov_long": nussinov_cuda.DECODE_LONG, "nw_long": nw_cuda.DECODE_LONG,
    }


class Launches:
    """While on, counts each kernel's launches (`counts`), the fold's
    ladder attempts on a card (`fold_attempts`: the calls of
    `mccaskill_cuda.mccaskill`, one a bucket shard and attempt) and the
    plain McCaskill's calls on card tensors (`plain_fold_on_card`)."""

    def __enter__(self):
        from dafs_tpu_torch.ops import mccaskill_cuda
        from dafs_tpu_torch.ops import mccaskill_kernel as MK

        self.fold_attempts = self.plain_fold_on_card = 0
        self.saved = card, plain = mccaskill_cuda.mccaskill, MK.mccaskill_fast

        def card_run(prep, sc):
            self.fold_attempts += 1
            return card(prep, sc)

        def counted(S, *a, **k):
            self.plain_fold_on_card += bool(S.is_cuda)
            return plain(S, *a, **k)

        mccaskill_cuda.mccaskill, MK.mccaskill_fast = card_run, counted
        self.before = {name: k.launches for name, k in kernels().items()}
        return self

    def __exit__(self, *exc):
        from dafs_tpu_torch.ops import mccaskill_cuda
        from dafs_tpu_torch.ops import mccaskill_kernel as MK

        mccaskill_cuda.mccaskill, MK.mccaskill_fast = self.saved
        self.counts = {name: k.launches - self.before[name] for name, k in kernels().items()}
        return False

    def hold(self, res=None, launched=(), idle=()):
        """The launch rules: each fold kernel once a ladder attempt of a
        bucket shard on the card, the plain McCaskill on no card tensor;
        given a run's result, each consensus kernel once a ladder attempt of
        its alifold calls (the diagonals are grid barriers inside a launch);
        every kernel of `launched` at least once, none of `idle`."""
        c = self.counts
        assert self.plain_fold_on_card == 0
        assert {n: c[n] for n in FOLD} == dict.fromkeys(FOLD, self.fold_attempts), c
        if res is not None:
            attempts = sum(x["attempts"] for x in res.consensus_calls if x["route"] == "alifold")
            assert {n: c[n] for n in CONSENSUS} == dict.fromkeys(CONSENSUS, attempts), c
        assert [n for n in launched if c[n] <= 0] == [], c
        assert [n for n in idle if c[n]] == [], c


# ------------------------------------------------------------- the runs --


@dataclasses.dataclass
class Run:
    """One row of the run table: an end-to-end run on the card and what it
    is held to.

    kind: "run" (`align_and_fold`), "verbose" (with standard output
    captured: one dump a host DD iteration), "aux" (a run that saves the
    posteriors first, then this one from the files), "param_file" (the
    fold must move under `-P`; after the reset a default run gives the
    bytes of the one before), "dryrun" (`dryrun_multichip`: three
    configurations on two shards of the card, each byte-equal to its
    single-device run) or "multiproc" (`parallel.multiproc`: ranks sharing
    the card under gloo, a card a rank under NCCL; its bitwise_equal flags).
    refs: (reference, what must equal it): a file of tests/snapshots/, or
    "default" (RF00005's default run on one device), "dd_host" (the same
    run with `dd_host=True`), "saved" (the run that saved the aux files);
    "topology" (the tree with its numbers taken out, and the names),
    "output" (also SS_cons and the rows), "uncapped" (the output where no
    merge stopped at the iteration cap with violations left) or "bytes".
    Launch rules: `Launches.hold`, with `launched` and `idle`; each kernel
    of `per_iteration` launched once a host DD iteration.  shards > 1: on
    a virtual mesh of that many shards of the card, and again across
    every card where there are several.  refined: the final score is at
    least the score before refinement."""

    id: str
    family: str = "RF00005_0.fa"
    kw: dict = dataclasses.field(default_factory=dict)
    flags: tuple = ()
    kind: str = "run"
    refs: tuple = ()
    launched: tuple = ()
    idle: tuple = ()
    per_iteration: tuple = ()
    shards: int = 1
    refined: bool = False


CONTRA = dict(align_model="CONTRAlign", fold_model="CONTRAfold")
BP_UPDATE = dict(use_bp_update=True, use_bp_update1=True)
# The end-to-end runs on the card (`Run` says what each field
# holds it to); the references in tests/snapshots/ are the TPU's output
# (*_tpu.txt) and `dafs_tpu`'s on the CPU (*_cpu.txt).  Most RF00017
# merges stop at the iteration cap, so RF00017 keeps only its topology.
RUNS = [
    Run("default RF00005", refs=(("rf00005_default_tpu.txt", "output"),), launched=MAIN,
        idle=PAIRCRF),
    Run("default RF00017", "RF00017_4.fa", refs=(("rf00017_default_tpu.txt", "topology"),),
        launched=MAIN, idle=PAIRCRF),
    Run("default family-50, 2 shards", "family-50", shards=2, launched=MAIN, idle=PAIRCRF),
    Run("(a) RF00005", kw=CONTRA, refs=(("rf00005_contrafold_contralign_cpu.txt", "topology"),),
        launched=DECODERS + PAIRCRF, idle=PAIRHMM),
    Run("(a) RF00017", "RF00017_4.fa", kw=CONTRA,
        refs=(("rf00017_contrafold_contralign_cpu.txt", "topology"),),
        launched=DECODERS + PAIRCRF, idle=PAIRHMM),
    Run("(b) RF00005", kw=BP_UPDATE, refs=(("rf00005_bp_update_cpu.txt", "topology"),),
        launched=PAIRHMM + DECODERS, idle=PAIRCRF),
    Run("(c) --ipknot", flags=("--ipknot",), refs=(("rf00005_ipknot_cpu.txt", "topology"),),
        launched=("nw",), idle=("nussinov",), per_iteration=("nw",)),
    Run("(d) -m 0", flags=("-m", "0"), refs=(("rf00005_ilp_cpu.txt", "output"),),
        idle=("nw",), per_iteration=("nw",)),
    Run("(e) -v 2", flags=("-v", "2"), kind="verbose", refs=(("dd_host", "bytes"),),
        per_iteration=("nw",)),
    Run("(g) -r 2", flags=("-r", "2"), refs=(("rf00005_refine2_cpu.txt", "uncapped"),),
        launched=PAIRHMM + DECODERS, refined=True),
    Run("(h) -f 0.5", flags=("-f", "0.5"), refs=(("rf00005_fourway_cpu.txt", "uncapped"),),
        launched=PAIRHMM + DECODERS),
    Run("(i) adagrad", flags=("--dd-update", "adagrad"),
        refs=(("rf00005_adagrad_cpu.txt", "uncapped"),), launched=PAIRHMM + DECODERS),
    Run("(j) adam", flags=("--dd-update", "adam"), refs=(("rf00005_adam_cpu.txt", "uncapped"),),
        launched=PAIRHMM + DECODERS),
    Run("(k) aux round trip", flags=("--align-aux", "{mp}", "--fold-aux", "{bp}"), kind="aux",
        refs=(("saved", "bytes"),), launched=DECODERS, idle=PAIRHMM),
    Run("(l) -P", flags=("-P", PAR_FILE), kind="param_file",
        refs=(("rf00005_param_file_cpu.txt", "uncapped"),), launched=PAIRHMM + DECODERS),
    Run("RF00017 -f 0.5 -r 1", "RF00017_4.fa", flags=("-f", "0.5", "-r", "1"),
        launched=PAIRHMM + DECODERS, refined=True),
    Run("(m2) dry run, 2 shards", kind="dryrun"),
    Run("(m3) RF00005, 2 shards", shards=2,
        refs=(("rf00005_default_tpu.txt", "output"), ("default", "bytes")),
        launched=PAIRHMM + DECODERS),
    Run("(m4) multiproc", kind="multiproc"),
]


def family(name):
    return family50() if name == "family-50" else read_fasta(name)


def cli_options(flags):
    """The `align_and_fold` keywords the port's CLI builds from `flags`: every
    `pipeline.Options` field, the models, the aux inputs and `-P`."""
    from dafs_tpu_torch import cli

    args = cli.build_parser().parse_args([*flags, "x.fa"])
    return dict(dataclasses.asdict(cli.options_from_args(args)),
                align_model=args.align_model, fold_model=args.fold_model,
                align_aux=args.align_aux, fold_aux=args.fold_aux, param_file=args.param_file)


def run_once(fa, device, kw, shards=1):
    """(result, Launches) of one `align_and_fold` run."""
    from dafs_tpu_torch import align_and_fold
    from dafs_tpu_torch.parallel import mesh

    with Launches() as n, mesh.virtual_mesh(shards) if shards > 1 else contextlib.nullcontext():
        res = align_and_fold(fa, device=device, **kw)
    return res, n


def placements(shards, dev):
    """(device, shards) of a sharded row: two shards of one card, then
    every visible card where there are several."""
    out = [(torch.device("cuda", 0), shards)]
    if torch.cuda.device_count() >= 2:
        out.append((dev, torch.cuda.device_count()))
    return out


def check_output(res, fa, pairs="()"):
    """Rows in input order, each its input sequence with gaps and as long
    as SS_cons; each bracket pair of `pairs` balanced in SS_cons, which
    holds nothing else but '.'."""
    seqs = {f.name: f.seq for f in fa}
    assert res.names == [f.name for f in fa]
    for name, row in zip(res.names, res.rows):
        assert row.replace("-", "") == seqs[name] and len(row) == len(res.ss_cons), name
    assert not set(res.ss_cons) - set(pairs) - {"."}, res.ss_cons
    for lo, hi in zip(pairs[::2], pairs[1::2]):
        depth = 0
        for ch in res.ss_cons:
            depth += (ch == lo) - (ch == hi)
            assert depth >= 0, res.ss_cons
        assert depth == 0, res.ss_cons


def check_against(res, ref, equal):
    """`res` against a reference output (a result or its string) as the
    run table's `equal` says."""
    if equal == "bytes":
        assert str(res) == str(ref)
        return
    tree, ss, names, rows = ref
    assert NUM.sub("#", res.tree) == NUM.sub("#", tree), (res.tree, tree)
    assert res.names == names
    capped = [m for m in res.device_dd if m[0] >= T_MAX and m[1] > 0]
    if equal == "output" or (equal == "uncapped" and not capped):
        assert (res.ss_cons, res.rows) == (ss, rows)


class recorded_posteriors:
    """Records the posteriors every model returns (`mp` and `bp`) while on."""

    def __init__(self, store):
        from dafs_tpu_torch.models import align_models, fold_models

        self.store = store
        self.targets = [(align_models.AlignModel, "all_pairs", "mp"),
                        (align_models.AUXAlign, "all_pairs", "mp"),
                        (fold_models.FoldModel, "all_seqs", "bp"),
                        (fold_models.AUXFold, "all_seqs", "bp")]

    def __enter__(self):
        self.saved = [getattr(cls, name) for cls, name, _ in self.targets]
        for (cls, name, key), fn in zip(self.targets, self.saved):
            def rec(*a, _fn=fn, _key=key, **kw):
                out = _fn(*a, **kw)
                self.store[_key] = out.copy()
                return out
            setattr(cls, name, rec)
        return self.store

    def __exit__(self, *exc):
        for (cls, name, _), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)


def multiproc(nprocs, one_card):
    """`parallel.multiproc` with `nprocs` ranks on the visible cards, or all
    on the first where `one_card`; returns its report."""
    env = dict(os.environ)
    if one_card:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    proc = subprocess.run(
        [sys.executable, "-m", "dafs_tpu_torch.parallel.multiproc", "--nprocs", str(nprocs),
         "--device", "cuda", "--timeout", "240"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def hold_run(run, dev, tmp):
    """Runs one row of the run table on the card and holds it to the row;
    returns each kernel's launches in the row's own run (on several cards,
    its last placement), or None for "multiproc", whose ranks count their
    own."""
    if run.kind == "dryrun":
        from dafs_tpu_torch.parallel import dryrun

        with Launches() as n:  # raises unless each output is its single-device run's
            dryrun.dryrun_multichip(2, torch.device("cuda", 0))
        n.hold(idle=LONG)
        return n.counts
    if run.kind == "multiproc":
        count = torch.cuda.device_count()
        for nprocs, one_card, collectives in [(2, True, "gloo")] + (
                [(count, False, "nccl")] if count >= 2 else []):
            report = multiproc(nprocs, one_card)
            assert report.get("ok") and report.get("collectives") == collectives, report
            assert all(report.get(k) for k in ("bitwise_equal_pairhmm", "bitwise_equal_pct_mp",
                                               "bitwise_equal_pct_bp")), report
        return None
    from dafs_tpu_torch.decoders_ip.ipknot import LEFT, RIGHT
    from dafs_tpu_torch.ops import energy_params, mccaskill

    fa = family(run.family)
    paths = {"mp": str(tmp / "mp.txt"), "bp": str(tmp / "bp.txt")}
    kw = dict(run.kw)
    if run.flags:
        kw.update(cli_options([f.format(**paths) for f in run.flags]))
    pairs = "".join(a + b for a, b in zip(LEFT, RIGHT)) if "--ipknot" in run.flags else "()"
    refs = {}
    for source, _ in run.refs:
        if source.endswith(".txt"):
            refs[source] = read_snapshot(source)
        elif source == "default":
            refs[source] = run_once(family("RF00005_0.fa"), dev, {})[0]
        elif source == "dd_host":
            refs[source], n = run_once(fa, dev, dict(kw, verbose=0, dd_host=True))
            n.hold(refs[source], idle=LONG)
    saved_arrays, arrays = {}, {}
    if run.kind == "aux":
        with recorded_posteriors(saved_arrays):
            saved, n = run_once(fa, dev, cli_options(["--save-align-aux", paths["mp"],
                                                      "--save-fold-aux", paths["bp"]]))
        n.hold(saved, launched=PAIRHMM + DECODERS, idle=LONG)
        refs["saved"] = saved
    if run.kind == "param_file":
        before = str(run_once(fa, dev, {})[0])
        fold0 = mccaskill.batch_bp_posteriors_fast([fa[0].seq], 0.0, dev)[0]
    for device, shards in placements(run.shards, dev) if run.shards > 1 else [(dev, 1)]:
        dumps = io.StringIO()
        try:
            with (contextlib.redirect_stdout(dumps) if run.kind == "verbose"
                  else contextlib.nullcontext()), (recorded_posteriors(arrays)
                                                   if run.kind == "aux"
                                                   else contextlib.nullcontext()):
                res, n = run_once(fa, device, kw, shards)
            if run.kind == "param_file":
                moved = mccaskill.batch_bp_posteriors_fast([fa[0].seq], 0.0, dev)[0]
        finally:
            if run.kind == "param_file":
                energy_params.set_param_overrides({})
        n.hold(res, launched=run.launched, idle=run.idle + LONG)
        iters = sum(t for t, _ in res.host_dd)
        assert {k: n.counts[k] for k in run.per_iteration} == dict.fromkeys(run.per_iteration,
                                                                           iters)
        check_output(res, fa, pairs)
        for source, equal in run.refs:
            check_against(res, refs[source], equal)
        if run.refined:
            assert res.refinements and res.score >= res.refinements[0]["s"]
        if run.kind == "verbose":
            assert dumps.getvalue().count("\n\n") == iters > 0
        if run.kind == "aux":
            assert all(np.array_equal(saved_arrays[k], arrays[k]) for k in ("mp", "bp"))
        if run.kind == "param_file":
            assert float(np.abs(moved.astype(np.float64) - fold0).max()) > 0.0
            assert not energy_params.PARAM_OVERRIDES
            assert str(run_once(fa, dev, {})[0]) == before
    return n.counts


def replay_rf00017(dev):
    """The RF00017 frozen replay (tests/test_rf00017_replay.py) through the
    port's host-loop DD with K3 and K4 on the card: the recorded
    posteriors, similarity and consensus matrices, the names of
    tests/data/RF00017_4.fa; the tree line, SS_cons and every row equal
    the frozen output, K4 launched once an iteration and K3 once more (the
    final decode)."""
    from dafs_tpu_torch import guide_tree, pipeline
    from dafs_tpu_torch.typedefs import gapped_seq

    data = np.load(os.path.join(SNAP, "rf00017_replay.npz"))
    fa = read_fasta("RF00017_4.fa")
    assert [f.name for f in fa] == list(data["names"]) and [f.seq for f in fa] == list(data["seqs"])
    calls = iter(range(int(data["n_ali_calls"])))

    def aln_key(aln, constraint=None):
        h = hashlib.sha256()
        for row in aln:
            h.update(str(row.seq_id).encode())
            h.update(np.asarray(row.mask, np.uint8).tobytes())
        if constraint:
            h.update(constraint.encode())
        return h.hexdigest()[:16]

    class ReplayAlifold:
        def consensus_bp(self, aln, fa_, device, constraint=None):
            i = next(calls)
            assert str(data[f"ali_key_{i}"]) == aln_key(aln, constraint), i
            return data[f"ali_out_{i}"]

    d = pipeline.Dafs(None, None, pipeline.Options(dd_host=True),
                      alifold_model=ReplayAlifold(), device=dev)
    d.fa, d.mp, d.bp = fa, data["mp"], data["bp"]
    d.tree = guide_tree.build_tree(data["sim"])
    with Launches() as n:
        _, _, aln = d._align(len(d.tree) - 1, {})
        _, sstr = d._decode_structure(d._avg_bp(aln, use_alifold=True), d.o.th_s1)
    lines = str(data["output"]).splitlines()
    rows = {"> " + fa[r.seq_id].name: gapped_seq(fa[r.seq_id].seq, r.mask) for r in aln}
    assert guide_tree.print_tree(d.tree, [f.name for f in fa]) == lines[0]
    assert sstr == lines[2]
    assert [rows[name] for name in lines[3::2]] == lines[4::2]
    iters = sum(t for t, _ in d.host_dd)
    assert (n.counts["nw"], n.counts["nussinov"]) == (iters, iters + 1)
    n.hold()


# -------------------------------------------------- kernel comparisons --


def agree(got, want, kind):
    """The consensus and fold tolerance, rtol 2e-4, with the atol each value
    takes: 1e-6 for the pair probabilities pout (as between the plain
    version and `dafs_tpu`); none for Q; a millionth of the largest |want|
    for qb's plane and the exterior chains q1 and qn, whose scale is the
    ladder's."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double().to(got.device)
    atol = {"pout": 1e-6, "Q": 0.0}.get(kind)
    if atol is None:
        atol = 1e-6 * float(want.abs().max())
    return bool(torch.allclose(got, want, rtol=2e-4, atol=atol))


def check_steps(runs):
    """Each kernel of `runs` ({CudaKernel: (run, its outputs, the plain
    step's, each output's tolerance kind)}, in launch order): one launch,
    two runs bit-equal, within tolerance of the plain step."""
    for kernel, (run, got, want, kinds) in runs.items():
        before = kernel.launches
        run()
        first = [g.clone() for g in got()]
        assert kernel.launches - before == 1
        run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, got())), kernel.symbol
        assert all(agree(g, w, k) for g, w, k in zip(got(), want, kinds)), kernel.symbol


def consensus_steps(dev, seqs, bl):
    """The consensus kernels one by one at the settled scale of `seqs`'s
    call, each against its plain step (`check_steps`: qb, q1, qn, Q and
    pout)."""
    from dafs_tpu_torch.ops import alifold, alifold_cuda
    from dafs_tpu_torch.ops import alifold_kernel as ak

    x = alifold._inputs(seqs, bl, None)
    n = x["n"]
    BCUT = alifold._bcut(x["S"], n)
    args = alifold.device_args(x, dev)
    sc = alifold.partition(args, n, x["bsn0"], alifold.SC0, BCUT, alifold_cuda.call_loops())[2]
    p = ak.prepare(*args, n, sc, x["bsn0"])
    qb_mat, qm, _, QBL = ak.inside(p, n, BCUT=BCUT)
    q1, qn, Q = ak.exterior(p, n, qb_mat)
    pout = ak.outside(p, n, QBL, qm, q1, qn, Q, BCUT=BCUT)
    pk = alifold_cuda.pack(p, n, BCUT)
    la = alifold_cuda.launch_args(pk)
    t = pk["tensors"]
    check_steps({
        alifold_cuda.INSIDE: (lambda: alifold_cuda.inside(pk, la), lambda: (t["qbl"],),
                              (QBL[0],), ("qb",)),
        alifold_cuda.EXTERIOR: (lambda: alifold_cuda.exterior(pk, la),
                                lambda: (t["q1"], t["qn"], t["q"].reshape(())), (q1, qn, Q),
                                ("q1", "qn", "Q")),
        alifold_cuda.OUTSIDE: (lambda: alifold_cuda.outside(pk, la), lambda: (t["pout"],),
                               (pout,), ("pout",)),
    })


def diag_to_rows(ld):
    """(B, Lp, Lp) diag-major ld[b, d, i] = M[b, i, i + d] as M."""
    B, Lp, _ = ld.shape
    d = torch.arange(Lp, device=ld.device)[:, None]
    i = torch.arange(Lp, device=ld.device)[None, :]
    ok = (i + d <= Lp - 1).expand(Lp, Lp)
    M = torch.zeros_like(ld)
    M[:, i.expand(Lp, Lp)[ok], (i + d).expand(Lp, Lp)[ok]] = ld[:, ok]
    return M


def fold_case(dev, seqs, cons=None, bl=True, start=None):
    """The fold of `seqs` through the pf-scale ladder on the card under the
    plain version and under the kernels (`traced_fold`): every
    attempt at the same scales with the same reading (good, over) of each
    row, the posteriors within rtol 2e-4 / atol 1e-6 and the last
    attempt's pout and Q as `agree` holds them; the kernels' attempt
    bit-equal across two runs; then each kernel against the plain step at
    the last attempt (`check_steps`).  start: None (exp(-0.6)), "over" (a
    scale at which every Q overflows, from the settled one) or "stable" (Q
    near 1)."""
    from dafs_tpu_torch.ops import mccaskill_cuda

    sc0 = None
    if start == "stable":
        sc0 = fold_stable_scale(seqs, dev, bl)
    elif start == "over":
        last = traced_fold(seqs, dev, bl, cons, None, plain=False)[2]
        q = last["Q"].cpu().numpy().astype(np.float64)
        ns = np.array([len(s) for s in seqs], np.float64)
        sc0 = (last["sc"].cpu().numpy() * (1e39 / q) ** (1.0 / ns)).astype(np.float32)
    want, tr_p, last_p = traced_fold(seqs, dev, bl, cons, sc0, plain=True)
    got, tr_k, last_k = traced_fold(seqs, dev, bl, cons, sc0, plain=False)
    assert tr_k == tr_p
    if start == "over":
        assert not any(tr_p[0][1])
    assert agree(last_k["pout"], last_p["pout"], "pout") and agree(last_k["Q"], last_p["Q"], "Q")
    assert all(agree(torch.from_numpy(g), torch.from_numpy(w), "pout") for g, w in zip(got, want))
    prep, sc = last_k["prep"], last_k["sc"]
    again = [x.clone() for x in mccaskill_cuda.mccaskill(prep, sc)]
    assert all(torch.equal(a, b) for a, b in zip(again, mccaskill_cuda.mccaskill(prep, sc)))
    parts = last_p["parts"]
    pk = mccaskill_cuda.pack(prep, sc)
    la = mccaskill_cuda.launch_args(pk)
    t = pk["tensors"]
    check_steps({
        mccaskill_cuda.INSIDE: (lambda: mccaskill_cuda.inside(pk, la),
                                lambda: (diag_to_rows(t["qbl"]),), (parts["qb"],), ("qb",)),
        mccaskill_cuda.EXTERIOR: (lambda: mccaskill_cuda.exterior(pk, la),
                                  lambda: (t["q1"], t["qn"], t["q"]),
                                  (parts["q1"], parts["qn"], last_p["Q"]), ("q1", "qn", "Q")),
        mccaskill_cuda.OUTSIDE: (lambda: mccaskill_cuda.outside(pk, la), lambda: (t["pout"],),
                                 (last_p["pout"],), ("pout",)),
    })


def same_bits(u, v) -> bool:
    """Whether two tensors hold the same bits (-0.0 is not 0.0)."""
    if u.dtype == torch.float32:
        u, v = u.view(torch.int32), v.view(torch.int32)
    return torch.equal(u, v)


DD_STATE = ("q_x", "q_y", "q_z", "eta", "c", "s_prev", "violated", "t", "x", "y", "z", "done")


def dd_states_equal(a, b) -> list:
    """The names of the state arrays in which two `dd._State`s differ in
    any bit (the optimiser planes as opt0, opt1, ...)."""
    pairs = [(n, getattr(a, n), getattr(b, n)) for n in DD_STATE]
    pairs += [(f"opt{k}", u, v) for k, (u, v) in enumerate(zip(a.opt, b.opt))]
    return [n for n, u, v in pairs if not same_bits(u, v)]


def compare_dd_bodies(problems, kw, rule, bodies):
    """Runs `bodies` loop bodies of one layer on the card through the step
    kernels and through the plain step; raises unless after every body the
    two states are bit-equal (q, the optimiser state, eta, c, s_prev, t,
    violated, x, y, z, done) and the kernels' score matrices for the next
    body are the plain version's.  Returns the merges done at the end."""
    from dafs_tpu_torch import dd

    _, k = dd_state(problems, kw, rule)
    _, p = dd_state(problems, kw, rule, plain=True)
    assert k.kernels is not None and p.kernels is None
    for body in range(bodies):
        dd._body(k)
        dd._body(p)
        bad = dd_states_equal(k, p)
        sm_xy, sm_z = dd._scores_plain(p)
        bad += [n for n, u, v in (("sm_xy", k.sm_xy, sm_xy), ("sm_z", k.sm_z, sm_z))
                if not same_bits(u, v)]
        assert not bad, f"DD step, {rule}, B {k.B} P1 {k.P1} P2 {k.P2}: body {body}: {bad}"
    return int(k.done.sum())


def solve_both_routes(problems, kw, rule):
    """One layer's `solve_by_dd_batch` on the card through the step kernels
    and through the plain step: (solutions, stats) of each."""
    from dafs_tpu_torch import dd

    out = []
    for plain in (False, True):
        stats = []
        with plain_dd_step() if plain else contextlib.nullcontext():
            sols = dd.solve_by_dd_batch(problems, **{**kw, "update_rule": rule, "stats": stats})
        out.append((sols, stats))
    return out


def dd_solutions_equal(a, b) -> bool:
    (sa, ta), (sb, tb) = a, b
    return ta == tb and all(
        np.float32(u[0]).tobytes() == np.float32(v[0]).tobytes()
        and all(np.array_equal(x, y) for x, y in zip(u[1:], v[1:])) for u, v in zip(sa, sb))


def valid_structure(ss, l):
    """Whether ss (left ends only, -1 elsewhere) is a nested structure
    within the true length l."""
    ss = ss.tolist()
    stack, right = [], {}
    for i, j in enumerate(ss):
        if j >= 0 and (i >= l or not i < j < l or j in right):
            return False
        if j >= 0:
            right[j] = i
    for i in range(l):
        if ss[i] >= 0:
            stack.append(ss[i])
        elif i in right:
            if not stack or stack.pop() != i:
                return False
    return not stack and all(v < 0 for v in ss[l:])


def valid_alignment(al, l1, l2):
    """Whether al matches increasing columns within l2, gaps (-1) elsewhere."""
    m = al[:l1][al[:l1] >= 0]
    return (bool((m < l2).all()) and bool((np.diff(m) > 0).all())
            and bool((al[l1:] < 0).all()))
