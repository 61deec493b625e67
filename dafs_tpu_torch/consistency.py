"""Similarity scores and probabilistic consistency transformations (PCT).

Port of `dafs_tpu/consistency.py`:
- calculate_similarity_score (src/dafs.cpp:713-764): a sparse NW-like DP
  with a path-length counter, as a row scan with a running max and a
  vectorized reconstruction of the Y-run lengths, batched over all sequence
  pairs;
- relax_matching_probability (src/dafs.cpp:258-324): the 3-way PCT
  p'(x_i,y_j) = sum_z w_z sum_k p(z_k,x_i) p(z_k,y_j) as batched matrix
  products over the padded (N, N, L, L) posterior tensor;
- relax_basepairing_probability (src/dafs.cpp:326-375):
  p'_x = sum_y w_y * M_yx^T B_y M_yx, likewise;
- relax_fourway_consistency (src/dafs.cpp:377-444, `-f`): the four-way PCT
  coupling match and pair posteriors, as two batched matrix chains.

The two 3-way PCTs split their worklists (the pairs; the sequences) over
the work mesh of `device` (`parallel.mesh`), as `dafs_tpu`'s
`_sharded_pct` does: each shard gets a copy of the posterior tensors and
runs its own entries, in chunks of fixed shape (`MP_CHUNK`, `BP_CHUNK`),
so a shard's results are the single-device run's bit for bit.  The
similarity DP and four-way PCT run on the mesh's first device.

The similarity DP is max-plus code and matches the JAX package bit for
bit.  The PCT products run through `torch.matmul` (full float32: TF32 is off
at package import); their sums reduce in another order than XLA's, so they
agree to float32 rounding.  The four-way products are numpy's in `dafs_tpu`;
on the CPU `torch.matmul` reduces as numpy's BLAS does and the result is
bit-equal; cuBLAS on the card may order the sums otherwise, so the card is
held to the CPU by tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from dafs_tpu_torch.parallel import mesh
from dafs_tpu_torch.typedefs import CUTOFF

NEGI = float(np.float32(-3e38))
MP_CHUNK = 32  # worklist pairs per batched product of the 3-way match PCT
BP_CHUNK = 8   # worklist sequences per batched product of the base-pair PCT


def _round_up(n, m):
    return -(-n // m) * m


def similarity_dp(p, present, l1, l2):
    """dp[l1][l2] and tr[l1][l2] of the similarity DP for a batch of pairs.

    p: (B, L1, L2) float32 match posteriors (0 where absent); present:
    (B, L1, L2) bool, True where the sparse matrix has an entry; l1, l2:
    (B,) true lengths.  Rows and columns past the true lengths never
    influence earlier ones, so padding is exact.
    """
    B, L1, L2 = p.shape
    dev = p.device
    jj = torch.arange(1, L2 + 1, device=dev)[None, :]
    zf = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    zi = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    dp_prev = torch.zeros((B, L2 + 1), dtype=torch.float32, device=dev)
    tr_prev = torch.zeros((B, L2 + 1), dtype=torch.int64, device=dev)
    dp_out = torch.zeros((B,), dtype=torch.float32, device=dev)
    tr_out = torch.zeros((B,), dtype=torch.int64, device=dev)
    col = l2.long()[:, None]
    for i in range(L1):
        ent_row = present[:, i]
        m_cand = torch.where(ent_row, dp_prev[:, :-1] + p[:, i], NEGI)
        x_cand = dp_prev[:, 1:]
        # dp[i][j] = max(m, x, dp[i][j-1]) with dp[i][0] = 0: a running max
        run = torch.cummax(torch.cat([zf, torch.maximum(m_cand, x_cand)], dim=1), dim=1).values
        left = run[:, :-1]   # dp[i][j-1]
        dpj = run[:, 1:]
        # choice per cell: entry cols M, else Y if dp == left, else X
        is_m = ent_row & (dpj == m_cand)
        is_y = ~is_m & (dpj == left)
        tr_non_y = torch.where(is_m, tr_prev[:, :-1] + 1, tr_prev[:, 1:] + 1)
        # Y-runs: tr[j] = tr[anchor] + (j - anchor), anchor = last non-Y cell
        anchor = torch.cummax(torch.where(is_y, 0, jj), dim=1).values
        tr_anchor_vals = torch.cat([zi, torch.where(is_y, 0, tr_non_y)], dim=1)
        anchored = tr_anchor_vals.gather(1, anchor)
        tr_row = torch.cat([zi, torch.where(is_y, anchored + (jj - anchor), tr_non_y)], dim=1)
        at = l1 == i + 1
        dp_out = torch.where(at, run.gather(1, col)[:, 0], dp_out)
        tr_out = torch.where(at, tr_row.gather(1, col)[:, 0], tr_out)
        dp_prev, tr_prev = run, tr_row
    return dp_out, tr_out


def similarity_matrix(mp: np.ndarray, lens: list[int], device) -> np.ndarray:
    """All-pairs similarity in one batched run.

    mp: (N, N, L, L) dense match posteriors (zeros where absent).  Returns
    the (N, N) matrix with 1.0 on the diagonal (src/dafs.cpp:1811-1819)."""
    N = mp.shape[0]
    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    if not pairs:
        return np.ones((N, N), np.float32)
    P = _round_up(max(lens), 32)
    B = len(pairs)
    pp = np.zeros((B, P, P), np.float32)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for b, (i, j) in enumerate(pairs):
        pp[b, : lens[i], : lens[j]] = mp[i, j, : lens[i], : lens[j]]
        l1[b], l2[b] = lens[i], lens[j]
    dev = torch.device(device)
    p = torch.from_numpy(pp).to(dev)
    dp, tr = similarity_dp(p, p > 0.0, torch.from_numpy(l1).to(dev), torch.from_numpy(l2).to(dev))
    dp, tr = dp.cpu().numpy(), tr.cpu().numpy()
    sim = np.ones((N, N), np.float32)
    for b, (i, j) in enumerate(pairs):
        sim[i, j] = sim[j, i] = np.float32(float(dp[b]) / float(tr[b]))
    return sim


def _pct_weights_match(sim: np.ndarray, x: int, y: int, w_pct: float) -> np.ndarray:
    """Per-z weights for relax_matching_probability (src/dafs.cpp:280-287)."""
    N = sim.shape[0]
    f = np.float32
    w = np.float32(sim[:, x] * sim[:, y])
    if w_pct < 0.0:
        w = np.float32(w * f(1.0 / N))
    else:
        scale = np.full(N, f(w_pct) / f(N - 2) if N > 2 else f(0.0), np.float32)
        scale[x] = f((1.0 - w_pct) / 2)
        scale[y] = f((1.0 - w_pct) / 2)
        w = np.float32(w * scale)
    return w


def match_worklist(sim: np.ndarray, w_pct_a: float):
    """The 3-way PCT's worklist: the pairs (x, y), x < y, in order, and per
    pair xs, ys (int64), its weights over z (B, N) and their float32 sum."""
    N = sim.shape[0]
    pairs = [(x, y) for x in range(N - 1) for y in range(x + 1, N)]
    xs = np.array([x for x, _ in pairs], np.int64)
    ys = np.array([y for _, y in pairs], np.int64)
    W = np.zeros((len(pairs), N), np.float32)
    for b, (x, y) in enumerate(pairs):
        W[b] = _pct_weights_match(sim, x, y, w_pct_a)
    sum_w = np.array([np.sum(w, dtype=np.float32) for w in W], np.float32)
    return pairs, xs, ys, W, sum_w


def basepair_worklist(sim: np.ndarray, w_pct_s: float):
    """The base-pair PCT's worklist: every sequence x (int64), its weights
    over y (N, N) and their float32 sum."""
    N = sim.shape[0]
    f = np.float32
    W = np.zeros((N, N), np.float32)
    sum_w = np.ones(N, np.float32)
    for x in range(N):
        w = np.float32(sim[:, x]).copy()
        if w_pct_s < 0.0:
            w = np.float32(w * f(1.0 / N))
        else:
            scale = np.full(N, f(w_pct_s) / f(N - 1) if N > 1 else f(0.0), np.float32)
            scale[x] = f(1.0 - w_pct_s)
            w = np.float32(w * scale)
        W[x] = w
        sum_w[x] = np.float32(np.sum(w, dtype=np.float32))
    return np.arange(N, dtype=np.int64), W, sum_w


def pad_worklist(rows: int, idx: tuple, W, sum_w):
    """A worklist padded to `rows` entries: index arrays with 0, weights
    with 0, sums of weights with 1 (finite zero results)."""
    return (tuple(mesh.pad_rows(a, rows, 0) for a in idx), mesh.pad_rows(W, rows, 0),
            mesh.pad_rows(sum_w, rows, 1))


def _chunks(chunk: int, idx: tuple, W, sum_w, dev):
    """The worklist padded to a multiple of `chunk`, its weights and their
    sums on `dev`, and the slice of each chunk."""
    Bp = _round_up(len(W), chunk)
    idx, W, sum_w = pad_worklist(Bp, idx, W, sum_w)
    return (idx, torch.from_numpy(W).to(dev), torch.from_numpy(sum_w).to(dev),
            [slice(c, c + chunk) for c in range(0, Bp, chunk)])


def relax_match_rows(m: torch.Tensor, xs, ys, W, sum_w) -> torch.Tensor:
    """The 3-way PCT of worklist entries on the device of `m`, the (N, N,
    L, L) posterior tensor: (B, L, L) with entries <= CUTOFF dropped, not
    yet cut to the lengths;
    post[b, i, j] = sum_{z, k} w[b, z] m[z, x_b, k, i] m[z, y_b, k, j] / sum_w[b].

    The products run MP_CHUNK entries at a time, the last chunk padded, so
    that every batched product has one shape whatever the worklist's
    length: cuBLAS picks its algorithm, and any split of the sum, by shape,
    and a shard's entries then equal the unsharded run's bit for bit."""
    N, _, L, _ = m.shape
    B = len(W)
    (xs, ys), Wt, swt, chunks = _chunks(MP_CHUNK, (xs, ys), W, sum_w, m.device)
    outs = []
    for c in chunks:
        a = (Wt[c, :, None, None] * m[:, xs[c]].transpose(0, 1)).reshape(MP_CHUNK, N * L, L)
        bm = m[:, ys[c]].transpose(0, 1).reshape(MP_CHUNK, N * L, L)
        post = torch.matmul(a.transpose(1, 2), bm) / swt[c, None, None]
        outs.append(torch.where(post <= CUTOFF, 0.0, post))
    return torch.cat(outs)[:B]


def relax_basepair_rows(b: torch.Tensor, m: torch.Tensor, xs, W, sum_w) -> torch.Tensor:
    """The base-pair PCT of worklist entries on the device of `b` (N, L, L)
    and `m` (N, N, L, L): (B, L, L) upper triangles with entries <= CUTOFF
    dropped, not yet cut to the lengths;
    post[b] = sum_y w[b, y] M_{y x_b}^T B_y M_{y x_b} / sum_w[b].
    BP_CHUNK entries at a time, the last chunk padded, for the reason
    `relax_match_rows` gives."""
    B = len(W)
    (xs,), Wt, swt, chunks = _chunks(BP_CHUNK, (xs,), W, sum_w, b.device)
    mt = m.transpose(0, 1)  # mt[x, y, k, i] = mp[y, x, k, i]
    outs = []
    for c in chunks:
        mx = mt[xs[c]]                                   # (x, y, k, i)
        inner = torch.matmul(b[None], mx)                # (x, y, k, j)
        terms = torch.matmul(mx.transpose(2, 3), inner)  # (x, y, i, j)
        post = torch.einsum("xy,xyij->xij", Wt[c], terms) / swt[c, None, None]
        post = torch.triu(post, 1)
        outs.append(torch.where(post <= CUTOFF, 0.0, post))
    return torch.cat(outs)[:B]


def _on_mesh(device, idx: tuple, W, sum_w, run, *tensors) -> np.ndarray:
    """A PCT worklist split over the work mesh of `device`
    (`parallel.mesh`): each shard gets a copy of the posterior `tensors`
    and runs `run` on its own entries; every shard is launched before any
    is read back, and the results come back in worklist order."""
    devices = mesh.work_devices(device)
    rows = len(W)
    padded, slices = mesh.shard_slices(rows, len(devices))
    idx, W, sum_w = pad_worklist(padded, idx, W, sum_w)
    copies = {d: [torch.from_numpy(t).to(d) for t in tensors] for d in set(devices)}
    outs = [run(*copies[d], *(a[sl] for a in idx), W[sl], sum_w[sl])
            for d, sl in zip(devices, slices)]
    return mesh.gather(outs, rows)


def relax_matching_probability(
    mp: np.ndarray, sim: np.ndarray, lens: list[int], w_pct_a: float, device
) -> np.ndarray:
    """3-way PCT over the padded (N, N, L, L) match-posterior tensor.

    mp[x, y] is the dense (L, L) match matrix of pair (x, y) (zeros beyond
    lens, zeros where below cutoff); mp[y, x] is its transpose and mp[x, x]
    identity.  Returns the transformed tensor with the same conventions
    (entries <= CUTOFF dropped).  The pairs split over the work mesh of
    `device`.
    """
    pairs, xs, ys, W, sum_w = match_worklist(sim, w_pct_a)
    if not pairs:
        return mp.copy()
    post = _on_mesh(device, (xs, ys), W, sum_w, relax_match_rows, mp)
    out = np.zeros_like(mp)
    for b, (x, y) in enumerate(pairs):
        p = post[b]
        p[lens[x]:, :] = 0.0
        p[:, lens[y]:] = 0.0
        out[x, y] = p
        out[y, x] = p.T
    for x in range(mp.shape[0]):
        out[x, x][np.arange(lens[x]), np.arange(lens[x])] = 1.0
    return out


def relax_basepairing_probability(
    bp: np.ndarray, mp: np.ndarray, sim: np.ndarray, lens: list[int],
    w_pct_s: float, device,
) -> np.ndarray:
    """PCT for base-pair posteriors: p'_x = sum_y w_y M_yx^T B_y M_yx.  The
    sequences split over the work mesh of `device`."""
    xs, W, sum_w = basepair_worklist(sim, w_pct_s)
    out = _on_mesh(device, (xs,), W, sum_w, relax_basepair_rows, bp, mp)
    for x in range(bp.shape[0]):
        out[x, lens[x]:, :] = 0.0
        out[x, :, lens[x]:] = 0.0
    return out


def relax_fourway_consistency(
    mp: np.ndarray, bp: np.ndarray, lens: list[int], w_pct_f: float, device
) -> np.ndarray:
    """Four-way PCT (src/dafs.cpp:377-444), coupling match and pair posteriors.

    posterior[i][k] = (1-w) p_ik + w [p_ik > 0] (sum_{j,l} p^x_ij p_jl p^y_kl
    + sum_{j,l} p^x_ji p_jl p^y_lk), all N(N-1)/2 pairs as one batched
    product on `device`, in `dafs_tpu`'s association and order:
    (B_x P) B_y^T and (B_x^T P) B_y, each added as post + (w * mask) * term.
    Entries <= CUTOFF are dropped; mp[y, x] is the transpose and mp[x, x]
    the identity."""
    N, _, L, _ = mp.shape
    pairs = [(x, y) for x in range(N - 1) for y in range(x + 1, N)]
    out = np.zeros_like(mp)
    if pairs:
        f = np.float32
        xs = [x for x, _ in pairs]
        ys = [y for _, y in pairs]
        dev = torch.device(device)
        P = torch.from_numpy(mp[xs, ys]).to(dev)
        bx = torch.from_numpy(bp[xs]).to(dev)
        by = torch.from_numpy(bp[ys]).to(dev)
        wm = (P > 0.0).to(torch.float32) * f(w_pct_f).item()
        post = P * f(1.0 - w_pct_f).item()
        post = post + wm * torch.matmul(torch.matmul(bx, P), by.transpose(1, 2))
        post = post + wm * torch.matmul(torch.matmul(bx.transpose(1, 2), P), by)
        post = torch.where(post <= CUTOFF, 0.0, post).cpu().numpy()
        for b, (x, y) in enumerate(pairs):
            p = post[b]
            p[lens[x]:, :] = 0.0
            p[:, lens[y]:] = 0.0
            out[x, y] = p
            out[y, x] = p.T
    for x in range(N):
        out[x, x][np.arange(lens[x]), np.arange(lens[x])] = 1.0
    return out
