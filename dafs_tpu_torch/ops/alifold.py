"""RNAalifold consensus partition function (ViennaRNA 2.4.x alipf_fold).

Port of the fast path of `dafs_tpu/ops/alifold.py`.  The reference mixes
RNAalifold consensus base-pair probabilities into every progressive-merge
step and the final decode (src/alifold.cpp:49-84, src/dafs.cpp:561-607).
The consensus extends the McCaskill recursion with
- a per-sequence axis: loop energies are evaluated per sequence with
  gap-aware loop sizes (a2s), sequence-local neighbor bases (S5/S3) and
  NN (type 7) handling for gapped pairs, then multiplied across sequences;
- the covariance pair score pscore[i,j] (Vienna's make_pscores with the
  default distance matrix, cv_fact=nc_fact=1), gating pairs at
  MINPSCORE=-200 and contributing exp(pscore/(kT/10*n_seq));
- column-based multiloop unpaired costs (expMLbase^n_seq per column) and
  column-based interior stencil bounds, as in alipfold.c.

Host prep is numpy; `alifold_kernel.prepare` builds the device inputs on
the caller's device, and the inside/outside runs there: the CUDA kernels of
`ops/alifold_cuda.py` on a card, the plain PyTorch loops
(`alifold_kernel.inside_outside`) on the CPU.  The slow reference recursion
(`_ali_inside_outside`) is not ported; it stays in `dafs_tpu` as an oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from dafs_tpu_torch import params
from dafs_tpu_torch.ops import alifold_cuda
from dafs_tpu_torch.ops import alifold_kernel as ak
from dafs_tpu_torch.ops import energy_params as ep
from dafs_tpu_torch.ops import mccaskill
from dafs_tpu_torch.typedefs import AlnRow
from dafs_tpu_torch.utils import spans

TURN = ep.TURN
UNIT = 100.0
MINPSCORE = -2.0 * UNIT
SC0 = np.exp(-0.6)  # first per-column scale of the retry ladder

# pair-type distance matrix (alifold.c, ribo=0 default)
DM = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0],
        [0, 0, 2, 2, 1, 2, 2],
        [0, 2, 0, 1, 2, 2, 2],
        [0, 2, 1, 0, 2, 1, 2],
        [0, 1, 2, 2, 0, 2, 1],
        [0, 2, 2, 1, 2, 0, 2],
        [0, 2, 2, 2, 1, 2, 0],
    ],
    dtype=np.float64,
)

_TABLES: dict = {}  # (bl, nseq) -> (kT-scaled table dict, kernel table dicts)


def _tables(bl: bool, nseq: int = 1):
    """Comparative pf tables (per-sequence factors with kTn = kT * n_seq,
    Vienna get_scaled_alipf_parameters, so the product over sequences
    weighs the AVERAGE energy), the kernel's table dict t2, and its loop and
    special tables and side-code tables (numpy; pure functions of the key)."""
    if (bl, nseq) not in _TABLES:
        t = ep.exp_tables(bl, kt_mult=nseq)
        t2 = dict(
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
        _TABLES[(bl, nseq)] = (
            t, t2, ak.build_loop_tables(t2), ak.build_special_tables(t2),
            ak.build_gtabs(t2),
        )
    return _TABLES[(bl, nseq)]


def make_pscores(S: np.ndarray, n: int, cv_fact=1.0, nc_fact=1.0) -> np.ndarray:
    """Covariance scores (alifold.c make_pscores, default dm), vectorized:
    per-cell pair-type counts as one-hot sums, the dm double sum as an
    einsum (dm is symmetric with zero diagonal, so sum_{k<=l} == full/2)."""
    nseq = S.shape[0]
    pt = ep.BP_PAIR[S[:, :, None], S[:, None, :]]  # (nseq, n+2, n+2)
    both_gap = (S[:, :, None] == 0) & (S[:, None, :] == 0)
    types = np.where(pt == 0, np.where(both_gap, 7, 0), pt)  # (nseq, ., .)
    counts = np.zeros((8,) + pt.shape[1:], dtype=np.int64)
    for k in range(8):
        counts[k] = (types == k).sum(axis=0)
    cf = counts[1:7].astype(np.float64)
    score = 0.5 * np.einsum("kij,lij,kl->ij", cf, cf, DM[1:7, 1:7])
    pscore_all = cv_fact * (
        (UNIT * score) / nseq
        - nc_fact * UNIT * (counts[0] + counts[7] * 0.25)
    )
    none_v = -2.0 * UNIT * 10
    ii = np.arange(pt.shape[1])
    valid = (
        (counts[0] * 2 + counts[7] <= nseq)
        & (ii[:, None] >= 1)
        & (ii[None, :] - ii[:, None] > TURN)
        & (ii[None, :] <= n)
    )
    return np.where(valid, pscore_all, none_v)


def _bcut(S: np.ndarray, n: int) -> int:
    """Small-loop support bound (alifold_kernel.inside_outside's BCUT).

    The pair-coupled B-group categories need a per-sequence loop size <= 2
    and the separable A-category indicators a loop size <= 3, i.e. an
    alignment window with <= 3 non-gap positions.  The longest such window
    over all sequences bounds the (u, v) corner where those terms can fire;
    buckets {8, 16, 31}."""
    maxw3 = 3  # a gapless alignment: any 4-column window has 4 non-gaps
    for s_i in range(S.shape[0]):
        pos = np.nonzero(S[s_i, 1 : n + 1] > 0)[0] + 1
        # sentinels: column 0 below, four n+1 above — len(q) >= 5 always,
        # and a gap-only sequence correctly yields the full-width window
        q = np.concatenate([[0], pos, [n + 1] * 4])
        maxw3 = max(maxw3, int((q[4:] - q[:-4]).max() - 1))
    for b in (8, 16):
        if maxw3 + 1 <= b:
            return b
    return ak.SW


def _inputs(seqs: list[str], bl: bool, constraint: str | None):
    """Host prep of one consensus call (numpy)."""
    nseq = len(seqs)
    n = len(seqs[0])
    L = -(-n // 32) * 32
    NS = nseq

    S = np.zeros((NS, L + 2), dtype=np.int32)
    for s_i, s in enumerate(seqs):
        S[s_i, 1 : n + 1] = ep.encode_rna(s.replace("-", "\0").replace("_", "\0"))
    # Vienna S5[s][i] = the base preceding i (skipping gaps), S3[s][i] = the
    # base following i; a2s = non-gap prefix counts (S[:,0] == S[:,L+1] == 0
    # serve as the "no base" sentinels).
    nz = S > 0
    a2s = np.cumsum(nz, axis=1, dtype=np.int32)
    a2s[:, n + 1 :] = a2s[:, n : n + 1]
    cols = np.arange(L + 2)
    ff = np.maximum.accumulate(np.where(nz, cols[None, :], 0), axis=1)
    S5 = np.zeros((NS, L + 2), dtype=np.int32)
    S5[:, 1 : n + 1] = np.take_along_axis(S, ff, axis=1)[:, 0:n]
    bpos = np.where(nz, cols[None, :], L + 1)
    bf = np.minimum.accumulate(bpos[:, ::-1], axis=1)[:, ::-1]
    S3 = np.zeros((NS, L + 2), dtype=np.int32)
    S3[:, 1 : n + 1] = np.take_along_axis(
        S, np.minimum(bf, L + 1), axis=1
    )[:, 2 : n + 2]

    t, t2, loop_tabs, spec_tabs, gtabs = _tables(bl, nseq)
    psc_n = make_pscores(S[:, : n + 2], n)
    psc = np.full((L + 2, L + 2), -2.0 * UNIT * 10, dtype=np.float64)
    psc[: n + 2, : n + 2] = psc_n
    # t["kt"] is already kT * n_seq (comparative params)
    kTn = t["kt"] / 10.0
    psc_fac = np.exp(np.where(psc >= MINPSCORE, psc, -1e9) / kTn)

    pt7 = ep.BP_PAIR[S[:, :, None], S[:, None, :]].astype(np.int32)
    pt7[pt7 == 0] = 7

    ii = np.arange(L + 2)
    allow_pair = psc >= MINPSCORE
    allow_pair &= (ii[None, :] - ii[:, None]) > TURN
    allow_pair &= (ii[:, None] >= 1) & (ii[None, :] <= n)
    allow_unpaired = np.ones(L + 2, dtype=bool)
    if constraint is not None:
        if len(constraint) != n:
            raise ValueError("constraint length differs from the alignment length")
        stack = []
        for k, ch in enumerate(constraint):
            pos = k + 1
            if ch == "x":
                allow_pair[pos, :] = False
                allow_pair[:, pos] = False
            elif ch == "(":
                stack.append(pos)
            elif ch == ")":
                a = stack.pop()
                keep = allow_pair[a, pos]
                allow_pair[a, :] = False
                allow_pair[:, a] = False
                allow_pair[pos, :] = False
                allow_pair[:, pos] = False
                allow_pair[a, pos] = keep

    # per-seq k-mer codes at alignment column i, over the UNGAPPED sequence
    # starting at sequence position a2s[i] (alipfold.c loopseq): base-4
    # packing of ung[p .. p+k-1], mapped back to non-gap columns
    tri_code = np.zeros((NS, L + 2), dtype=np.int32)
    tetra_code = np.zeros((NS, L + 2), dtype=np.int32)
    hexa_code = np.zeros((NS, L + 2), dtype=np.int32)
    for s_i in range(NS):
        ung = S[s_i][S[s_i] > 0].astype(np.int64)
        m = len(ung)
        cols_ng = np.nonzero(S[s_i, 1 : n + 1] > 0)[0] + 1  # (m,) columns
        for k, arr in ((5, tri_code), (6, tetra_code), (8, hexa_code)):
            if m < k:
                continue
            vals = np.zeros(m - k + 1, dtype=np.int64)
            for dd in range(k):
                vals = vals * 4 + (ung[dd : m - k + 1 + dd] - 1)
            arr[s_i, cols_ng[: m - k + 1]] = vals.astype(np.int32)

    Lp = L + 2
    planes = ak.build_planes(
        t2, S, S5, S3, a2s, pt7, tri_code, tetra_code, hexa_code, n, NS, Lp,
    )

    def bigvec(arr, repl_last=False):
        out = np.zeros((NS, ak.PAD + Lp + Lp + ak.PAD), np.int32)
        out[:, ak.PAD : ak.PAD + Lp] = arr
        if repl_last:
            out[:, ak.PAD + Lp :] = arr[:, -1:]
        return out

    return dict(
        n=n, L=L, S=S, S5=S5, S3=S3, a2s=a2s, pt7=pt7,
        codes=(tri_code, tetra_code, hexa_code), planes=planes, psc_fac=psc_fac,
        allow_pair=allow_pair, allow_unpaired=allow_unpaired,
        S5b=bigvec(S5), S3b=bigvec(S3), A2Sb=bigvec(a2s, repl_last=True),
        loop_tabs=loop_tabs, spec_tabs=spec_tabs, gtabs=gtabs,
        bsn0=np.float32(t["ml_base"]) ** nseq,  # per-column ML base (col reading)
    )


def device_args(x: dict, dev) -> tuple:
    """The tensors of `_inputs`' output `x` on `dev`, as
    `alifold_kernel.prepare` takes them before (n, sc, bsn0)."""
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    planes = {k: as_t(v) for k, v in x["planes"].items()}
    planes.update(ak.build_seq_planes(
        params.to_device(x["gtabs"], dev), as_t(x["S"]), as_t(x["S5"]), as_t(x["S3"]),
    ))
    return (
        planes, params.to_device(x["loop_tabs"], dev),
        params.to_device(x["spec_tabs"], dev),
        as_t(x["psc_fac"].astype(np.float32)), as_t(x["allow_pair"]),
        as_t(x["allow_unpaired"]), as_t(x["S5b"]), as_t(x["S3b"]), as_t(x["A2Sb"]),
    )


def partition(args: tuple, n: int, bsn0, sc0, BCUT: int, loops):
    """The pf-scale retry ladder: `loops` (the CUDA kernels'
    `alifold_cuda.inside_outside` or a call's `alifold_cuda.call_loops()`, or
    the plain `alifold_kernel.inside_outside`)
    on `prepare(*args, n, sc, bsn0)` from the per-column scale sc0, scaled
    by 0.8 while Q overflows (or is not finite) and by 1.25 while it
    underflows, at most 24 attempts, each a span "consensus.attempt".
    Returns (pout as numpy (Lp, Lp), Q, the scale that stabilized Q,
    attempts)."""
    sc = np.float32(sc0)
    for attempt in range(1, 25):
        with spans.span("consensus.attempt", sc=float(sc)):
            pout, Q = loops(ak.prepare(*args, n, sc, bsn0), n, BCUT=BCUT)
            Qv = float(Q)
            pout_h = pout.cpu().numpy()
        if np.isfinite(Qv) and 1e-25 < Qv < 1e25 and np.isfinite(pout_h).all():
            return pout_h, Qv, sc, attempt
        if not np.isfinite(Qv) or Qv >= 1e25:
            sc = np.float32(sc * 0.8)
        else:
            sc = np.float32(sc * 1.25)
    raise FloatingPointError(
        f"alifold: partition function did not stabilize (L={n}, nseq={args[6].shape[0]})"
    )


class Alifold:
    """Consensus base-pair probabilities of an alignment group (class
    Alifold, src/alifold.h:29-35).

    Holds the pf-scale warm start: per (n_seq, padded length) key, the last
    per-column scale that stabilized Q.  Progressive merges fold closely
    related alignments, so the first attempt almost always succeeds and the
    0.8x/1.25x ladder runs on cold keys only.  The JAX package keeps this in
    a module global that lives as long as its process; here it lives on the
    object and spans every run made with it, and `align_and_fold` builds a
    new one per call, so every such call starts from the state of a fresh
    JAX process.  pm = pout/Q is scale-invariant up to float32 rounding.

    `calls` records one dict per consensus call (n_seq, length, route,
    ladder attempts, host seconds; for the alifold route also the seconds
    of its host prep, `_inputs` and the copies to the device) for the
    caller's accounting: the seconds of its spans "consensus.call" and
    "consensus.prep".

    `leaves` maps an ungapped sequence to McCaskill posteriors the caller
    already holds for it under this object's parameter set, before any
    threshold (the pipeline's fold stage sets it per run).  An unconstrained
    group of one such sequence is served from them instead of a second,
    identical McCaskill run.
    """

    def __init__(self, th: float, bl: bool = True):
        self.th = th
        self.bl = bl
        self.sc_cache: dict = {}
        self.calls: list[dict] = []
        self.leaves: dict = {}

    def consensus_bp(self, aln: list[AlnRow], fa, device, constraint: str | None = None):
        """(L, L) consensus pair probabilities of the gapped rows of `aln`."""
        seqs = []
        for row in aln:
            s = fa[row.seq_id].seq
            out = []
            k = 0
            for m in row.mask:
                out.append(s[k] if m else "-")
                k += bool(m)
            seqs.append("".join(out))
        return self.consensus(seqs, device, constraint)

    def consensus(self, seqs: list[str], device, constraint: str | None = None,
                  bcut: int | None = None) -> np.ndarray:
        """(L, L) upper-triangular consensus pair probabilities of the gapped
        strings `seqs` (entries > th and > 1e-6, clipped to [0, 1]).

        bcut: raises the computed B-group support bound (never below it),
        capped at the full stencil width 31; for tests of the cut."""
        nseq = len(seqs)
        prep = None
        with spans.timed("consensus.call", ns=nseq, n=len(seqs[0])) as call:
            if nseq == 1 and "-" not in seqs[0] and "_" not in seqs[0]:
                # A single ungapped sequence reduces exactly to the McCaskill
                # partition function: every per-seq loop size equals the
                # column offset, kTn = kT, the covariance factor is exp(0) =
                # 1, and the pscore >= MINPSCORE gate admits exactly the
                # canonical pairs.  Vienna's plist 1e-6 cutoff is applied the
                # same way.
                if constraint is None and seqs[0] in self.leaves:
                    route = "fold stage"
                    pm = self.leaves[seqs[0]].copy()
                    pm[pm <= self.th] = 0.0
                else:
                    route = "mccaskill"
                    pm = mccaskill.batch_bp_posteriors_fast(
                        seqs, self.th, device, bl=self.bl,
                        constraints=None if constraint is None else [constraint],
                    )[0]
                pm[pm <= 1e-6] = 0.0
                info = dict(ns=1, n=len(seqs[0]), route=route, attempts=None)
            else:
                with spans.timed("consensus.prep") as prep:
                    x = _inputs(seqs, self.bl, constraint)
                    n, L = x["n"], x["L"]
                    BCUT = _bcut(x["S"], n)
                    if bcut is not None:
                        BCUT = max(BCUT, min(ak.SW, bcut))

                    dev = torch.device(device)
                    loops = alifold_cuda.call_loops() if dev.type == "cuda" else ak.inside_outside
                    key = (nseq, L)
                    args = device_args(x, dev)
                pout_h, _, sc, attempt = partition(args, n, x["bsn0"],
                                                self.sc_cache.get(key, SC0), BCUT, loops)
                self.sc_cache[key] = float(sc)
                pm = pout_h[1 : n + 1, 1 : n + 1].astype(np.float32)
                pm[pm <= self.th] = 0.0
                pm[pm <= 1e-6] = 0.0
                np.clip(pm, 0.0, 1.0, out=pm)
                info = dict(ns=nseq, n=n, route="alifold", bcut=BCUT, attempts=attempt)
            call.attrs.update(info)
        info["seconds"] = call.seconds
        if prep is not None:
            info["prep_seconds"] = prep.seconds
        self.calls.append(info)
        return pm


def consensus_bp(seqs: list[str], th: float, bl: bool = True, constraint: str | None = None,
                 device="cuda") -> np.ndarray:
    """(L, L) upper-triangular consensus pair probabilities of the gapped
    strings `seqs` (entries > th), as `dafs_tpu.ops.alifold.consensus_bp`
    returns them: `Alifold(th, bl).consensus(seqs, device, constraint)`.
    Each call starts the pf-scale ladder cold, as a fresh `dafs_tpu`
    process does; only the fast path exists here."""
    return Alifold(th, bl).consensus(seqs, device, constraint)
