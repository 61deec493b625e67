"""Dual-decomposition solver for the progressive-merge steps.

Port of `dafs_tpu/dd.py` (DAFS::solve_by_dd, src/dafs.cpp:1006-1295) with
its three multiplier update rules (subgradient, adagrad, adam;
src/dafs.cpp:984-1004).  The merges of one guide-tree layer are solved
together: every iteration runs ONE batched Nussinov decode over the x and y
problems of all merges (kernel K3 on the card), ONE batched NW decode over
their alignments (kernel K4), the violation counts over the consensus
base-pair candidates, and the sparse multiplier updates (as masked dense
updates; the reference's SPARSE_UPDATE branch touches exactly the cells
these masks select).

Merges that converge are frozen by a `done` mask (their multipliers and
optimiser state alike), as the JAX package's batched while_loop freezes
them, so each merge's result equals its own
solve whenever the host looks at the mask.  The iterations are driven from a
Python loop; a CUDA graph or a persistent kernel is later work.

Host-side preparation per merge (candidate enumeration, the alignment
envelope, padding to 32-multiples) is numpy, copied from the JAX package.

Two host solvers of one merge at a time, reached through the serial merge
recursion of `pipeline.Dafs._align`: `solve_by_dd_ipknot`, the host-loop
DD (`--ipknot`, `-v 2` and `dd_host`), whose multiplier arithmetic is numpy
float32 in the JAX package's order and whose decodes are the port's own
(K3 and K4 on the card), and `solve_by_ip`, the exact joint ILP of `-m 0`
(scipy's HiGHS `milp`), copied as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nussinov, nw
from portbench.reference.typedefs import CUTOFF

# iterations between host checks of the `done` mask (each check waits for
# the device); results do not depend on it
DONE_CHECK_EVERY = 8


def _round_up(n, m):
    return -(-n // m) * m


def enumerate_cbp(p_x, p_y, p_z, n1, n2, w, min_th_s, th_a, for_ip=False):
    """Consensus base-pair candidates (src/dafs.cpp:1022-1044).

    Returns (U, 4) int64 array of (i, j, k, l) rows.
    p weighting: DD mode uses (N1*p_x + N2*p_y)/(N1+N2); IP mode plain mean
    (src/dafs.cpp:1032 vs :1336).
    """
    f = np.float32
    xi, xj = np.nonzero(p_x > CUTOFF)
    keep_x = xj > xi
    xi, xj = xi[keep_x], xj[keep_x]
    yk, yl = np.nonzero(p_y > CUTOFF)
    keep_y = yl > yk
    yk, yl = yk[keep_y], yl[keep_y]
    if xi.size == 0 or yk.size == 0:
        return np.zeros((0, 4), dtype=np.int64)

    # cross product (i,j) x (k,l), filtered by the z-conditions
    zi = p_z[xi[:, None], yk[None, :]] > CUTOFF  # p_z[i][k]
    zj = p_z[xj[:, None], yl[None, :]] > CUTOFF  # p_z[j][l]
    mask = zi & zj
    if for_ip:
        p = (p_x[xi[:, None], xj[:, None]] + p_y[yk[None, :], yl[None, :]]) / f(2.0)
    else:
        p = (
            f(n1) * p_x[xi[:, None], xj[:, None]]
            + f(n2) * p_y[yk[None, :], yl[None, :]]
        ) / f(n1 + n2)
    q = (p_z[xi[:, None], yk[None, :]] + p_z[xj[:, None], yl[None, :]]) / f(2.0)
    mask &= (p - f(min_th_s) > 0.0) & (
        f(w) * (p - f(min_th_s)) + (q - f(th_a)) > 0.0
    )
    a, b = np.nonzero(mask)
    # order like the reference loop nest (i asc, j asc, k asc, l asc)
    return np.stack([xi[a], xj[a], yk[b], yl[b]], axis=1).astype(np.int64)


def _prep_dd_problem(p_x, p_y, p_z, n1, n2, *, w, th_s, th_a, P1, P2, U):
    """Pad one merge's inputs to (P1, P2, U); returns the per-merge arrays
    of `_dd_core` (numpy)."""
    f = np.float32
    L1, L2 = p_z.shape
    min_th_s = min(th_s)
    cbp = enumerate_cbp(p_x, p_y, p_z, n1, n2, w, min_th_s, th_a)
    env = nw.envelope(p_z, th_a)

    pxp = np.zeros((P1, P1), np.float32)
    pxp[:L1, :L1] = p_x
    pyp = np.zeros((P2, P2), np.float32)
    pyp[:L2, :L2] = p_y
    pzp = np.zeros((P1, P2), np.float32)
    pzp[:L1, :L2] = p_z

    cbp_pad = np.zeros((U, 4), np.int64)
    cbp_pad[: len(cbp)] = cbp
    cbp_valid = np.zeros(U, bool)
    cbp_valid[: len(cbp)] = True

    in_cx = np.zeros((P1, P1), bool)
    in_cy = np.zeros((P2, P2), bool)
    in_cz = np.zeros((P1, P2), bool)
    if len(cbp):
        in_cx[cbp[:, 0], cbp[:, 1]] = True
        in_cy[cbp[:, 2], cbp[:, 3]] = True
        in_cz[cbp[:, 0], cbp[:, 2]] = True
        in_cz[cbp[:, 1], cbp[:, 3]] = True

    envf = np.zeros(P1 + 1, np.int32)
    envl = np.zeros(P1 + 1, np.int32)
    envf[: L1 + 1] = env[:, 0]
    envl[: L1 + 1] = env[:, 1]
    envl[L1 + 1:] = L2

    w_x = f(f(w) * 2 * n1 / (n1 + n2))
    w_y = f(f(w) * 2 * n2 / (n1 + n2))
    return dict(
        p_x=pxp, p_y=pyp, p_z=pzp, in_cx=in_cx, in_cy=in_cy, in_cz=in_cz,
        cbp=cbp_pad, cbp_valid=cbp_valid, env_first=envf, env_last=envl,
        l1=np.int32(L1), l2=np.int32(L2), w_x=w_x, w_y=w_y,
        n_cbp4=f(4.0 * max(len(cbp), 1)),
    )


def _adam_bias_corrections(t_max):
    """1 - b ** (t + 1) for t < t_max, b = 0.9 and 0.999, in float32.

    numpy's float32 power (the C library's powf); XLA's own `power`, which
    `dafs_tpu` runs for `b ** tf`, differs from it in the last bit for a few
    t (tests/test_torch_options.py).  A table read by each merge's own t
    gives the card and the CPU the same values."""
    tf = np.arange(1, max(t_max, 1) + 1, dtype=np.float32)
    one = np.float32(1.0)
    return (one - np.power(np.float32(0.9), tf), one - np.power(np.float32(0.999), tf))


def _dd_core(pr, *, th_s0, th_a, eta0, t_max, update_rule="subgradient"):
    """The DD loop over a batch of merges.

    pr: dict of batched device tensors (leading dim B) from
    `_prep_dd_problem`.  update_rule: "subgradient" (a step width eta per
    merge that shrinks when the bound does not improve), or the per-entry
    "adagrad" or "adam" steps of `dafs_tpu/dd.py:162-188`, whose state
    starts at zero and moves only at the entries a step updates.  Returns
    (s, t, violated, x, y, z) per merge.
    """
    if update_rule not in ("subgradient", "adagrad", "adam"):
        raise ValueError(f"unknown DD update rule {update_rule!r}")
    p_x, p_y, p_z = pr["p_x"], pr["p_y"], pr["p_z"]
    B, P1, _ = p_x.shape
    P2 = p_y.shape[1]
    P = max(P1, P2)
    dev = p_x.device
    f32 = torch.float32
    bi = torch.arange(B, device=dev)[:, None]
    ci, cj, ck, cl = pr["cbp"].unbind(dim=2)
    cbp_valid = pr["cbp_valid"]
    in_cx, in_cy, in_cz = pr["in_cx"], pr["in_cy"], pr["in_cz"]
    l1, l2 = pr["l1"], pr["l2"]
    lens_xy = torch.cat([l1, l2])
    w_x = pr["w_x"][:, None, None]
    w_y = pr["w_y"][:, None, None]
    n_cbp4 = pr["n_cbp4"]
    ii1 = torch.arange(P1, device=dev)
    ii2 = torch.arange(P2, device=dev)
    th_s0 = torch.tensor(th_s0, dtype=f32, device=dev)
    th_a = torch.tensor(th_a, dtype=f32, device=dev)
    eta0 = torch.tensor(eta0, dtype=f32, device=dev)

    q_x = torch.zeros_like(p_x)
    q_y = torch.zeros_like(p_y)
    q_z = torch.zeros_like(p_z)
    eta = eta0.expand(B).clone()
    c = torch.zeros((B,), dtype=f32, device=dev)
    s_prev = torch.zeros((B,), dtype=f32, device=dev)
    violated = torch.full((B,), -1, dtype=torch.int64, device=dev)
    t = torch.zeros((B,), dtype=torch.int64, device=dev)
    x = torch.full((B, P1), -1, dtype=torch.int32, device=dev)
    y = torch.full((B, P2), -1, dtype=torch.int32, device=dev)
    z = torch.full((B, P1), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    # one padded buffer for the x and y structure problems of every merge;
    # cells past a problem's true length are never read by the decoder
    sm_xy = torch.zeros((2 * B, P, P), dtype=f32, device=dev)
    # optimiser state per merge: g2 of x, y, z (adagrad), or m of x, y, z
    # then v of x, y, z (adam)
    n_opt = {"subgradient": 0, "adagrad": 3, "adam": 6}[update_rule]
    opt = [torch.zeros_like(q) for q in (q_x, q_y, q_z) * 2][:n_opt]
    if update_rule == "adagrad":
        eps = torch.tensor(1e-6, dtype=f32, device=dev)
    elif update_rule == "adam":
        eps = torch.tensor(1e-8, dtype=f32, device=dev)
        b1 = torch.tensor(0.9, dtype=f32, device=dev)
        b2 = torch.tensor(0.999, dtype=f32, device=dev)
        bc1_tab, bc2_tab = (torch.from_numpy(b).to(dev) for b in _adam_bias_corrections(t_max))

    def one_hot(v, n):
        return ((v[:, :, None] == torch.arange(n, device=dev)) & (v >= 0)[:, :, None]).to(torch.int32)

    def counts(shape, rows, cols, act):
        out = torch.zeros((B, *shape), dtype=f32, device=dev)
        for r, k in zip(rows, cols):
            out.index_put_((bi.expand_as(r), r, k), act, accumulate=True)
        return out.to(torch.int32)

    for it in range(t_max):
        if it % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        run = ~done
        sm_xy[:B, :P1, :P1] = nussinov.score_matrix(w_x, p_x, q_x, th_s0)
        sm_xy[B:, :P2, :P2] = nussinov.score_matrix(w_y, p_y, q_y, th_s0)
        s_xy, xy = nussinov.decode(sm_xy, lens_xy)
        x_new, y_new = xy[:B, :P1], xy[B:, :P2]
        sm_z = p_z - th_a + q_z
        s_z, z_new = nw.decode(sm_z, pr["env_first"], pr["env_last"], l1, l2)
        s = s_xy[:B] + s_xy[B:] + s_z

        # violation counts over consensus candidates (src/dafs.cpp:1103-1117)
        s_w = (
            q_x[bi, ci, cj] + q_y[bi, ck, cl]
            - q_z[bi, ci, ck] - q_z[bi, cj, cl]
        )
        active = (s_w > 0.0) & cbp_valid
        s = s + torch.sum(torch.where(active, s_w, 0.0), dim=1)
        af = active.to(f32)
        t_x = counts((P1, P1), [ci], [cj], af)
        t_y = counts((P2, P2), [ck], [cl], af)
        t_z = counts((P1, P2), [ci, cj], [ck, cl], af)

        # multiplier updates (sparse branch src/dafs.cpp:1120-1254, dense form)
        X = one_hot(x_new, P1)
        Y = one_hot(y_new, P2)
        Z = one_hot(z_new, P2)
        eta3 = eta[:, None, None]
        dx = (t_x - X).to(f32)
        upd_x = ((X > 0) | in_cx) & (dx != 0.0)
        dy = (t_y - Y).to(f32)
        upd_y = ((Y > 0) | in_cy) & (dy != 0.0)
        dz = (Z - t_z).to(f32)
        mz = (Z > 0) | in_cz
        upd_z = mz & (dz != 0.0)
        # per-entry step (src/dafs.cpp:984-1004), in `dafs_tpu`'s order
        ds, upds = (dx, dy, dz), (upd_x, upd_y, upd_z)
        if update_rule == "adagrad":
            opt_new = [torch.where(u, g2 + d * d, g2) for g2, d, u in zip(opt, ds, upds)]
            steps = [(eta0 * d) / torch.sqrt(g2 + eps) for g2, d in zip(opt_new, ds)]
        elif update_rule == "adam":
            bc1 = bc1_tab[t][:, None, None]
            bc2 = bc2_tab[t][:, None, None]
            ms = [torch.where(u, b1 * m + (1.0 - b1) * d, m) for m, d, u in zip(opt[:3], ds, upds)]
            vs = [torch.where(u, b2 * v + ((1.0 - b2) * d) * d, v)
                  for v, d, u in zip(opt[3:], ds, upds)]
            steps = [(eta0 * (m / bc1)) / (torch.sqrt(v / bc2) + eps)
                     for m, v in zip(ms, vs)]
            opt_new = ms + vs
        else:
            steps = [eta3 * d for d in ds]
            opt_new = []
        q_x_new = torch.where(upd_x, q_x - steps[0], q_x)
        q_y_new = torch.where(upd_y, q_y - steps[1], q_y)
        q_z_new = torch.where(
            mz, torch.clamp(q_z - torch.where(upd_z, steps[2], 0.0), min=0.0), q_z
        )
        viol_z = ((Z > 0) & (t_z > 1)) | ((Z == 0) & in_cz & (t_z > 0))
        violated_new = upd_x.sum((1, 2)) + upd_y.sum((1, 2)) + viol_z.sum((1, 2))
        done_new = violated_new == 0

        # step width (src/dafs.cpp:1283-1288, subgradient only); on break the
        # reference skips the eta update AND keeps the previous s_prev
        if update_rule == "subgradient":
            improve = ((s > s_prev) | (t == 0)) & ~done_new
            c_new = c + torch.clamp(n_cbp4 - violated_new.to(f32), min=0.0) / n_cbp4
            c_new = torch.where(improve, c_new, c)
            eta_new = torch.where(improve, eta0 / (1.0 + c_new), eta)
        else:
            c_new, eta_new = c, eta
        s_new = torch.where(done_new, s_prev, s)

        # freeze merges that finished in an earlier iteration
        r3 = run[:, None, None]
        q_x = torch.where(r3, q_x_new, q_x)
        q_y = torch.where(r3, q_y_new, q_y)
        q_z = torch.where(r3, q_z_new, q_z)
        opt = [torch.where(r3, o_new, o) for o_new, o in zip(opt_new, opt)]
        eta = torch.where(run, eta_new, eta)
        c = torch.where(run, c_new, c)
        s_prev = torch.where(run, s_new, s_prev)
        violated = torch.where(run, violated_new, violated)
        t = t + run.to(t.dtype)
        x = torch.where(run[:, None], x_new, x)
        y = torch.where(run[:, None], y_new, y)
        z = torch.where(run[:, None], z_new, z)
        done = done | (run & done_new)
    return s_prev, t, violated, x, y, z


def solve_by_dd_batch(problems, *, w, th_s, th_a, eta0, t_max, device,
                      update_rule="subgradient", stats=None):
    """Solve a batch of independent merges together on `device`.

    problems: list of (p_x, p_y, p_z, n1, n2) numpy problems.  All are padded
    to the batch's common (P1, P2, U) buckets.  Returns a list of
    (s, x, y, z), x/y/z int64 vectors with -1 = unpaired/unaligned; appends
    each merge's (iterations, violations at exit) to the list `stats` when
    one is given.
    """
    s, t, violated, x, y, z = (
        v.cpu().numpy()
        for v in _dd_core(
            prep_batch(problems, w=w, th_s=th_s, th_a=th_a, device=device),
            th_s0=float(np.float32(th_s[0])), th_a=float(np.float32(th_a)),
            eta0=float(np.float32(eta0)), t_max=t_max, update_rule=update_rule,
        )
    )
    out = []
    for b, (_, _, p_z, _, _) in enumerate(problems):
        L1, L2 = p_z.shape
        if stats is not None:
            stats.append((int(t[b]), int(violated[b])))
        out.append((
            float(s[b]),
            x[b, :L1].astype(np.int64),
            y[b, :L2].astype(np.int64),
            z[b, :L1].astype(np.int64),
        ))
    return out


def prep_batch(problems, *, w, th_s, th_a, device):
    """The batched `_dd_core` inputs of a list of merge problems, on
    `device`."""
    P1 = max(_round_up(p[2].shape[0], 32) for p in problems)
    P2 = max(_round_up(p[2].shape[1], 32) for p in problems)
    u_max = max(
        len(enumerate_cbp(p_x, p_y, p_z, n1, n2, w, min(th_s), th_a))
        for (p_x, p_y, p_z, n1, n2) in problems
    )
    U = max(_round_up(max(u_max, 1), 256), 256)
    preps = [
        _prep_dd_problem(p_x, p_y, p_z, n1, n2, w=w, th_s=th_s, th_a=th_a,
                         P1=P1, P2=P2, U=U)
        for (p_x, p_y, p_z, n1, n2) in problems
    ]
    dev = torch.device(device)
    return {
        k: torch.from_numpy(np.stack([p[k] for p in preps])).to(dev)
        for k in preps[0]
    }
