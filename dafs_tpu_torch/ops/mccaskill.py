"""McCaskill partition function with ViennaRNA 2.4.x energy semantics.

Port of the fast path of `dafs_tpu/ops/mccaskill.py`: base-pair posteriors
under the Turner-2004 nearest-neighbor model with dangles=2, with the
Andronescu BL* overrides (`-s Boltzmann`, the default).  The sequences of
one 32-length bucket run as one batch through `mccaskill_kernel`.

Scaling: a per-base scale factor (Vienna's pf_scale^-1) starts at exp(-0.6)
and is retried per sequence on over/underflow, exactly as the JAX package's
ladder; probabilities are scale-invariant, so this only affects rounding.

The slow reference recursion (`_inside_outside`) is not ported; it stays
in `dafs_tpu` as an oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from dafs_tpu_torch import params
from dafs_tpu_torch.ops import energy_params as ep
from dafs_tpu_torch.ops import mccaskill_kernel as MK
from dafs_tpu_torch.parallel.mesh import shard_slices

TURN = ep.TURN
MAXLOOP = ep.MAXLOOP


def _round_up(n, m):
    return -(-n // m) * m


def _kmer_codes(s_codes: np.ndarray, k: int, L: int) -> np.ndarray:
    """code of the k-mer starting at 1-based position i (0 if out of range).

    s_codes: (L+2,) Vienna base codes (1..4); code digits are base-1 in base 4.
    """
    out = np.zeros(L + 2, dtype=np.int32)
    n = len(s_codes) - 2
    for i in range(1, n - k + 2):
        v = 0
        ok = True
        for d in range(k):
            b = int(s_codes[i + d]) - 1
            if b < 0:
                ok = False
                break
            v = v * 4 + b
        out[i] = v if ok else 0
    return out


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


def batch_bp_posteriors_fast(seqs, th, device, bl=True, constraints=None, devices=None):
    """BP posteriors of a list of sequences: one batched run per 32-length
    bucket.  Returns dense (n, n) float32 numpy matrices (upper triangle),
    entries kept only when strictly greater than `th`, clipped to [0, 1].

    devices: the shards of a work mesh (`parallel.mesh`), `[device]` by
    default.  Each bucket is padded to a multiple of their count with
    trivial length-1 rows (`ns = 1`) and split over them in order; every
    attempt of the pf-scale ladder launches every shard, and only the real
    rows decide whether it is retried, as in `dafs_tpu`."""
    devices = [torch.device(device)] if devices is None else devices
    tabs = {d: params.to_device(_fast_tabs(bl), d) for d in set(devices)}
    f32 = np.float32
    out: list = [None] * len(seqs)
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        buckets.setdefault(_round_up(len(s), 32), []).append(i)
    for L, idxs in buckets.items():
        B, slices = shard_slices(len(idxs), len(devices))
        S = np.zeros((B, L + 2), np.int32)
        PT = np.zeros((B, L + 2, L + 2), np.int32)
        AP = np.zeros((B, L + 2, L + 2), bool)
        AU = np.zeros((B, L + 2), bool)
        CODES = np.zeros((3, B, L + 2), np.int32)
        ns = np.ones(B, np.int32)  # padding rows: trivial length-1 problems
        for bi, i in enumerate(idxs):
            c = constraints[i] if constraints is not None else None
            S[bi], PT[bi], AP[bi], AU[bi] = _prepare(seqs[i], L, c)
            for ci, k in enumerate((5, 6, 8)):  # tri-, tetra-, hexaloop k-mers
                CODES[ci, bi] = _kmer_codes(S[bi], k, L)
            ns[bi] = len(seqs[i])
        shards = []
        for dev, sl in zip(devices, slices):
            as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)  # noqa: E731
            shards.append((dev, sl, (as_t(S), as_t(PT), as_t(AP), as_t(AU), as_t(ns)),
                           tuple(as_t(c) for c in CODES)))
        sc = np.full(B, np.exp(-0.6), np.float32)
        for _ in range(16):
            runs = [MK.mccaskill_fast(*args, torch.from_numpy(sc[sl]).to(dev), codes, tabs[dev])
                    for dev, sl, args, codes in shards]
            Qv = np.concatenate([Q.cpu().numpy() for _, Q in runs])
            pm = np.concatenate([pout.cpu().numpy() for pout, _ in runs])
            good = (
                np.isfinite(Qv) & (Qv > 1e-25) & (Qv < 1e25)
                & np.isfinite(pm).all(axis=(1, 2))
            )
            if good[: len(idxs)].all():
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
