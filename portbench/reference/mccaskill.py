"""McCaskill partition function with ViennaRNA 2.4.x energy semantics.

Port of the fast path of `dafs_tpu/ops/mccaskill.py`: base-pair posteriors
under the Turner-2004 nearest-neighbor model with dangles=2, with the
Andronescu BL* overrides (`-s Boltzmann`, the default).  The sequences of
one 32-length bucket run as one batch through `mccaskill_kernel`.

Scaling: a per-base scale factor (Vienna's pf_scale^-1) starts at exp(-0.6)
and is retried per sequence on over/underflow, exactly as the JAX package's
ladder; probabilities are scale-invariant, so this only affects rounding.

Each ladder attempt of a bucket runs the plain version
`mccaskill_kernel.mccaskill_fast`, on the card too.

The slow reference recursion (`_inside_outside`) is not ported; it stays
in `dafs_tpu` as an oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import params
from portbench.reference import energy_params as ep
from portbench.reference import mccaskill_kernel as MK

TURN = ep.TURN
MAXLOOP = ep.MAXLOOP


def _round_up(n, m):
    return -(-n // m) * m


def kmer_codes(S: torch.Tensor) -> tuple:
    """The codes of the 5-, 6- and 8-mers (a tri-, tetra- or hexaloop with
    its closing pair) starting at each 1-based position of S (B, L+2)
    Vienna base codes, on S's device, int32: the bases' codes minus 1 as
    base-4 digits, 0 where the k-mer holds an N or runs past the sequence."""
    S = S.long()
    B, Lp = S.shape
    pad = torch.cat([S, torch.zeros((B, 8), dtype=S.dtype, device=S.device)], dim=1)
    out = []
    for k in (5, 6, 8):
        code = torch.zeros_like(S)
        ok = torch.ones_like(S, dtype=torch.bool)
        for d in range(k):
            digit = pad[:, d : d + Lp] - 1
            ok &= digit >= 0
            code = code * 4 + digit.clamp(min=0)
        out.append(torch.where(ok, code, 0).to(torch.int32))
    return tuple(out)


def _prepare(seq: str, L: int, constraint: str | None):
    n = len(seq)
    s = np.zeros(L + 2, dtype=np.int32)
    s[1 : n + 1] = ep.encode_rna(seq)
    pt = ep.BP_PAIR[s[:, None], s[None, :]].astype(np.int32)
    allow_pair = pt > 0
    allow_unpaired = np.ones(L + 2, dtype=bool)
    ii = np.arange(L + 2)
    allow_pair &= (ii[None, :] - ii[:, None]) > TURN
    allow_pair &= (ii[:, None] >= 1) & (ii[None, :] <= n)
    if constraint is not None:
        if len(constraint) != n:
            raise ValueError("constraint length differs from the sequence length")
        stack = []
        forced = []
        for k, ch in enumerate(constraint):
            pos = k + 1
            if ch == "x":
                allow_pair[pos, :] = False
                allow_pair[:, pos] = False
            elif ch == "(":
                stack.append(pos)
            elif ch == ")":
                forced.append((stack.pop(), pos))
        for (a, b) in forced:
            keep = allow_pair[a, b]
            allow_pair[a, :] = False
            allow_pair[:, a] = False
            allow_pair[b, :] = False
            allow_pair[:, b] = False
            allow_pair[a, b] = keep
    return s, pt, allow_pair, allow_unpaired


_FAST_TABLES: dict = {}


def _fast_tabs(bl: bool) -> dict:
    """Boltzmann-factor tables of the fast kernel as numpy (float32 arrays
    and scalars), the same dict `dafs_tpu`'s `_fast_tabs` builds."""
    if bl not in _FAST_TABLES:
        t = ep.exp_tables(bl)
        f32 = np.float32
        lxc = f32(np.exp(-t["lxc"] * 10.0 / t["kt"]))
        tabs = {
            "stack": t["stack"], "hairpin": t["hairpin"], "bulge": t["bulge"],
            "mmH": t["mismatchH"], "mmI": t["mismatchI"],
            "mm1n": t["mismatch1nI"], "mm23": t["mismatch23I"],
            "mmExt": t["mismatchExt"], "d5": t["dangle5"], "d3": t["dangle3"],
            "mmM": t["mismatchM"],
            "i11": t["int11"], "i21": t["int21"], "i22": t["int22"],
            "mlb": f32(t["ml_base"]), "mlc": f32(t["ml_closing"]),
            "mli": f32(t["ml_intern"]), "tau": f32(t["terminal_au"]),
            "lxc": lxc,
            "tetra": t["tetraloop"], "tri": t["triloop"], "hexa": t["hexaloop"],
        }
        tabs = {
            k: (np.asarray(v, np.float32) if not np.isscalar(v) else f32(v))
            for k, v in tabs.items()
        }
        # static per-(u, s) stencil constants (s = u + v)
        SW = MAXLOOP + 1
        uu = np.arange(SW).astype(np.float64)
        u_g = uu[:, None] + np.zeros((1, SW))
        s_g = np.zeros((SW, 1)) + uu[None, :]
        v_g = s_g - u_g
        valid_uv = (v_g >= 0) & (s_g <= MAXLOOP)
        internal = np.asarray(t["internal"], np.float64)
        bulge_np = np.asarray(t["bulge"], np.float64)
        ninio = np.asarray(t["ninio"], np.float64)
        si_ = np.clip(s_g.astype(int), 0, MAXLOOP)
        asym = np.clip(np.abs(u_g - v_g).astype(int), 0, MAXLOOP)
        nl_uv = np.maximum(u_g, v_g).astype(int)
        special = (
            ((u_g == 0) & (v_g == 0))
            | ((u_g == 0) & (v_g == 1)) | ((u_g == 1) & (v_g == 0))
            | ((u_g == 1) & (v_g == 1))
            | ((u_g == 1) & (v_g == 2)) | ((u_g == 2) & (v_g == 1))
            | ((u_g == 2) & (v_g == 2))
        )
        mask_1n = valid_uv & (((u_g == 1) & (v_g >= 3)) | ((v_g == 1) & (u_g >= 3)))
        mask_23 = valid_uv & (((u_g == 2) & (v_g == 3)) | ((u_g == 3) & (v_g == 2)))
        mask_bul = valid_uv & (((u_g == 0) & (v_g >= 2)) | ((v_g == 0) & (u_g >= 2)))
        mask_gen = valid_uv & (u_g >= 1) & (v_g >= 1) & ~special & ~mask_1n & ~mask_23
        tabs["C_gen"] = np.where(mask_gen, internal[si_] * ninio[asym], 0.0).astype(np.float32)
        tabs["C_1n"] = np.where(
            mask_1n,
            internal[np.clip(nl_uv + 1, 0, MAXLOOP)] * ninio[np.clip(nl_uv - 1, 0, MAXLOOP)],
            0.0,
        ).astype(np.float32)
        tabs["C_23"] = np.where(mask_23, internal[5] * ninio[1], 0.0).astype(np.float32)
        tabs["C_tau"] = np.where(
            mask_bul, bulge_np[np.clip(nl_uv, 0, MAXLOOP)], 0.0
        ).astype(np.float32)
        _FAST_TABLES[bl] = tabs
    return _FAST_TABLES[bl]


def bucket_inputs(seqs, L, B, constraints=None):
    """`mccaskill_fast`'s arguments of one 32-length bucket but the k-mer
    codes (`kmer_codes`), as numpy arrays: (S, PT, AP, AU, ns), B rows, the
    sequences first and then trivial length-1 rows (`ns = 1`, nothing
    unpaired)."""
    S = np.zeros((B, L + 2), np.int32)
    PT = np.zeros((B, L + 2, L + 2), np.int32)
    AP = np.zeros((B, L + 2, L + 2), bool)
    AU = np.zeros((B, L + 2), bool)
    ns = np.ones(B, np.int32)  # padding rows: trivial length-1 problems
    for bi, seq in enumerate(seqs):
        c = constraints[bi] if constraints is not None else None
        S[bi], PT[bi], AP[bi], AU[bi] = _prepare(seq, L, c)
        ns[bi] = len(seq)
    return S, PT, AP, AU, ns


def batch_bp_posteriors_fast(seqs, th, device, bl=True, constraints=None):
    """BP posteriors of a list of sequences: one batched run per 32-length
    bucket.  Returns dense (n, n) float32 numpy matrices (upper triangle),
    entries kept only when strictly greater than `th`, clipped to [0, 1]."""
    dev = torch.device(device)
    tabs = params.to_device(_fast_tabs(bl), dev)
    f32 = np.float32
    out: list = [None] * len(seqs)
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        buckets.setdefault(_round_up(len(s), 32), []).append(i)
    for L, idxs in buckets.items():
        B = len(idxs)
        S, PT, AP, AU, ns = bucket_inputs(
            [seqs[i] for i in idxs], L, B,
            None if constraints is None else [constraints[i] for i in idxs])
        args = tuple(torch.from_numpy(a).to(dev) for a in (S, PT, AP, AU, ns))
        codes = kmer_codes(args[0])
        sc = np.full(B, np.exp(-0.6), np.float32)
        for _ in range(16):
            pout, Q = MK.mccaskill_fast(*args, torch.from_numpy(sc).to(dev), codes, tabs)
            Qv, pm = Q.cpu().numpy(), pout.cpu().numpy()
            good = (
                np.isfinite(Qv) & (Qv > 1e-25) & (Qv < 1e25)
                & np.isfinite(pm).all(axis=(1, 2))
            )
            if good.all():
                break
            over = ~np.isfinite(Qv) | (Qv >= 1e25)
            sc = np.where(good, sc, np.where(over, f32(sc * 0.8), f32(sc * 1.25)))
        else:
            raise FloatingPointError("mccaskill_fast: batch did not stabilize")
        for bi, i in enumerate(idxs):
            n = len(seqs[i])
            p = pm[bi, 1 : n + 1, 1 : n + 1].astype(np.float32).copy()
            p[p <= th] = 0.0
            np.clip(p, 0.0, 1.0, out=p)
            out[i] = p
    return out
