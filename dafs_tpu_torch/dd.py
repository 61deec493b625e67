"""Dual-decomposition solver for the progressive-merge steps.

Port of `dafs_tpu/dd.py` (DAFS::solve_by_dd, src/dafs.cpp:1006-1295) with
its three multiplier update rules (subgradient, adagrad, adam;
src/dafs.cpp:984-1004).  The merges of one guide-tree layer are solved
together: every iteration runs ONE batched Nussinov decode over the x and y
problems of all merges (kernel K3 on the card), ONE batched NW decode over
their alignments (kernel K4), then the multiplier step: the violation counts
over the consensus base-pair candidates and the sparse multiplier updates
(as masked dense updates; the reference's SPARSE_UPDATE branch touches
exactly the cells these masks select).

Merges that converge are frozen by a `done` mask (their multipliers and
optimiser state alike), as the JAX package's batched while_loop freezes
them, so each merge's result equals its own
solve whenever the host looks at the mask.  The iterations are driven from a
Python loop.  On the card the step is three hand-written kernels and one
`torch.sum` a body (`ops/dd_step_cuda`, `csrc/dd_step.cu`), bit-equal to
the plain step `_step_plain`, which runs for CPU tensors; a body is then
six launches.  A CUDA graph over them is later work.

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

from dafs_tpu_torch.ops import dd_step_cuda, nussinov, nw
from dafs_tpu_torch.typedefs import CUTOFF
from dafs_tpu_torch.utils import spans
from dafs_tpu_torch.utils.log import logger

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


# the adaptive rules' constants, as `dafs_tpu/dd.py:162-188` gives them
_EPS = {"adagrad": 1e-6, "adam": 1e-8}
_ADAM_B1, _ADAM_B2 = 0.9, 0.999


class _State:
    """The DD loop's state for one batch of merges, on `pr`'s device.

    The multipliers q_x, q_y, q_z; the optimiser state `opt` (g2 of x, y,
    z (adagrad), or m of x, y, z then v of x, y, z (adam)), which starts at
    zero and moves only at the entries a step updates; per merge eta (the
    subgradient step width), c, s_prev, violated, t, x, y, z and done; the
    score matrices of the next body's decodes, `sm_xy` (one padded buffer
    for the x and y structure problems of every merge; cells past a
    problem's true length are never read by the decoder) and `sm_z`.

    On a CUDA device `kernels` is the step kernels (`ops/dd_step_cuda.Step`)
    bound to this state, which update it in place and write each next
    body's score matrices; on the CPU it is None and `_step_plain` rebinds
    the attributes to new tensors."""

    def __init__(self, pr, *, th_s0, th_a, eta0, t_max, update_rule):
        if update_rule not in ("subgradient", "adagrad", "adam"):
            raise ValueError(f"unknown DD update rule {update_rule!r}")
        self.pr, self.update_rule, self.t_max = pr, update_rule, t_max
        p_x, p_y, p_z = pr["p_x"], pr["p_y"], pr["p_z"]
        B, P1, _ = p_x.shape
        P2 = p_y.shape[1]
        P = max(P1, P2)
        self.B, self.P1, self.P2 = B, P1, P2
        dev = self.dev = p_x.device
        f32 = torch.float32
        self.bi = torch.arange(B, device=dev)[:, None]
        self.lens_xy = torch.cat([pr["l1"], pr["l2"]])
        self.w_x = pr["w_x"][:, None, None]
        self.w_y = pr["w_y"][:, None, None]
        # float32 values as Python floats (the kernels' arguments), and those
        # the plain version uses as 0-d tensors
        self.consts = {k: float(np.float32(v)) for k, v in dict(
            th_s0=th_s0, th_a=th_a, eta0=eta0, eps=_EPS.get(update_rule, 0.0),
            b1=_ADAM_B1, b2=_ADAM_B2).items()}
        used = {"subgradient": (), "adagrad": ("eps",), "adam": ("eps", "b1", "b2")}[update_rule]
        for k in ("th_s0", "th_a", "eta0", *used):
            setattr(self, k, torch.tensor(self.consts[k], dtype=f32, device=dev))

        self.q_x = torch.zeros_like(p_x)
        self.q_y = torch.zeros_like(p_y)
        self.q_z = torch.zeros_like(p_z)
        self.eta = self.eta0.expand(B).clone()
        self.c = torch.zeros((B,), dtype=f32, device=dev)
        self.s_prev = torch.zeros((B,), dtype=f32, device=dev)
        self.violated = torch.full((B,), -1, dtype=torch.int64, device=dev)
        self.t = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.x = torch.full((B, P1), -1, dtype=torch.int32, device=dev)
        self.y = torch.full((B, P2), -1, dtype=torch.int32, device=dev)
        self.z = torch.full((B, P1), -1, dtype=torch.int32, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.sm_xy = torch.zeros((2 * B, P, P), dtype=f32, device=dev)
        n_opt = {"subgradient": 0, "adagrad": 3, "adam": 6}[update_rule]
        self.opt = [torch.zeros_like(q) for q in (self.q_x, self.q_y, self.q_z) * 2][:n_opt]
        if update_rule == "adam":
            self.bc1_tab, self.bc2_tab = (
                torch.from_numpy(b).to(dev) for b in _adam_bias_corrections(t_max))
        self.kernels = None
        if dev.type != "cpu":
            # the first body's score matrices; the kernels write the later ones
            _, self.sm_z = _scores_plain(self)
            self.kernels = dd_step_cuda.Step(pr, self)


def _scores_plain(st):
    """The score matrices of the state's multipliers: `st.sm_xy` filled,
    and a new `sm_z`."""
    B, P1, P2, pr = st.B, st.P1, st.P2, st.pr
    st.sm_xy[:B, :P1, :P1] = nussinov.score_matrix(st.w_x, pr["p_x"], st.q_x, st.th_s0)
    st.sm_xy[B:, :P2, :P2] = nussinov.score_matrix(st.w_y, pr["p_y"], st.q_y, st.th_s0)
    return st.sm_xy, pr["p_z"] - st.th_a + st.q_z


def _body(st):
    """One loop body: the score matrices, ONE batched Nussinov decode over
    the x and y problems of every merge (K3 on the card), ONE batched NW
    decode (K4), then the multiplier step."""
    pr = st.pr
    sm_xy, sm_z = _scores_plain(st) if st.kernels is None else (st.sm_xy, st.sm_z)
    s_xy, xy = nussinov.decode(sm_xy, st.lens_xy)
    s_z, z_new = nw.decode(sm_z, pr["env_first"], pr["env_last"], pr["l1"], pr["l2"])
    _step(st, s_xy, xy, s_z, z_new)


def _step(st, s_xy, xy, s_z, z_new):
    """The multiplier step of one body from its decodes (K3's s_xy, xy and
    K4's s_z, z_new): the step kernels for a state on the card, in place
    (`ops/dd_step_cuda`), `_step_plain` for one on the CPU."""
    if st.kernels is None:
        _step_plain(st, s_xy, xy, s_z, z_new)
    else:
        st.kernels(s_xy, xy, s_z, z_new)


def _step_plain(st, s_xy, xy, s_z, z_new):
    """Plain version of the step kernels (`csrc/dd_step.cu`): the violation
    counts over the consensus candidates, the multiplier updates of the
    update rule, and the freeze of merges that finished in an earlier
    body, each array of `st` rebound to a new tensor."""
    pr, B, P1, P2, dev = st.pr, st.B, st.P1, st.P2, st.dev
    f32 = torch.float32
    bi = st.bi
    ci, cj, ck, cl = pr["cbp"].unbind(dim=2)
    cbp_valid = pr["cbp_valid"]
    in_cx, in_cy, in_cz = pr["in_cx"], pr["in_cy"], pr["in_cz"]
    n_cbp4 = pr["n_cbp4"]
    eta0 = st.eta0
    q_x, q_y, q_z, opt = st.q_x, st.q_y, st.q_z, st.opt
    eta, c, s_prev, t = st.eta, st.c, st.s_prev, st.t
    if st.update_rule == "adagrad":
        eps = st.eps
    elif st.update_rule == "adam":
        eps, b1, b2 = st.eps, st.b1, st.b2

    def one_hot(v, n):
        return ((v[:, :, None] == torch.arange(n, device=dev)) & (v >= 0)[:, :, None]).to(torch.int32)

    def counts(shape, rows, cols, act):
        out = torch.zeros((B, *shape), dtype=f32, device=dev)
        for r, k in zip(rows, cols):
            out.index_put_((bi.expand_as(r), r, k), act, accumulate=True)
        return out.to(torch.int32)

    run = ~st.done
    x_new, y_new = xy[:B, :P1], xy[B:, :P2]
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
    if st.update_rule == "adagrad":
        opt_new = [torch.where(u, g2 + d * d, g2) for g2, d, u in zip(opt, ds, upds)]
        steps = [(eta0 * d) / torch.sqrt(g2 + eps) for g2, d in zip(opt_new, ds)]
    elif st.update_rule == "adam":
        bc1 = st.bc1_tab[t][:, None, None]
        bc2 = st.bc2_tab[t][:, None, None]
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
    if st.update_rule == "subgradient":
        improve = ((s > s_prev) | (t == 0)) & ~done_new
        c_new = c + torch.clamp(n_cbp4 - violated_new.to(f32), min=0.0) / n_cbp4
        c_new = torch.where(improve, c_new, c)
        eta_new = torch.where(improve, eta0 / (1.0 + c_new), eta)
    else:
        c_new, eta_new = c, eta
    s_new = torch.where(done_new, s_prev, s)

    # freeze merges that finished in an earlier iteration
    r3 = run[:, None, None]
    st.q_x = torch.where(r3, q_x_new, q_x)
    st.q_y = torch.where(r3, q_y_new, q_y)
    st.q_z = torch.where(r3, q_z_new, q_z)
    st.opt = [torch.where(r3, o_new, o) for o_new, o in zip(opt_new, opt)]
    st.eta = torch.where(run, eta_new, eta)
    st.c = torch.where(run, c_new, c)
    st.s_prev = torch.where(run, s_new, s_prev)
    st.violated = torch.where(run, violated_new, st.violated)
    st.t = t + run.to(t.dtype)
    st.x = torch.where(run[:, None], x_new, st.x)
    st.y = torch.where(run[:, None], y_new, st.y)
    st.z = torch.where(run[:, None], z_new, st.z)
    st.done = st.done | (run & done_new)


def _dd_core(pr, *, th_s0, th_a, eta0, t_max, update_rule="subgradient"):
    """The DD loop over a batch of merges.

    pr: dict of batched device tensors (leading dim B) from
    `_prep_dd_problem`.  update_rule: "subgradient" (a step width eta per
    merge that shrinks when the bound does not improve), or the per-entry
    "adagrad" or "adam" steps of `dafs_tpu/dd.py:162-188`, whose state
    starts at zero and moves only at the entries a step updates.  Returns
    (s, t, violated, x, y, z) per merge.  Adds the loop bodies it ran to
    the counter "iterations" of the innermost open span, and those whose
    step ran as the step kernels to "step_kernel_bodies" (all of them on
    the card, none on the CPU); each blocking read of the `done` mask is a
    span "dd.check".
    """
    st = _State(pr, th_s0=th_s0, th_a=th_a, eta0=eta0, t_max=t_max, update_rule=update_rule)
    iterations = t_max
    for it in range(t_max):
        if it % DONE_CHECK_EVERY == 0:
            with spans.span("dd.check"):
                finished = bool(st.done.all())
            if finished:
                iterations = it
                break
        _body(st)
    spans.count("iterations", iterations)
    spans.count("step_kernel_bodies", 0 if st.kernels is None else st.kernels.bodies)
    return st.s_prev, st.t, st.violated, st.x, st.y, st.z


def solve_by_dd_batch(problems, *, w, th_s, th_a, eta0, t_max, device,
                      update_rule="subgradient", stats=None):
    """Solve a batch of independent merges together on `device`.

    problems: list of (p_x, p_y, p_z, n1, n2) numpy problems.  All are padded
    to the batch's common (P1, P2, U) buckets.  Returns a list of
    (s, x, y, z), x/y/z int64 vectors with -1 = unpaired/unaligned; appends
    each merge's (iterations, violations at exit) to the list `stats` when
    one is given.

    Spans: "dd.solve" (attribute solver "dd_batch"), and in it "dd.prep",
    "dd.upload" (`prep_batch`), "dd.loop" (`_dd_core`: attributes B, P1,
    P2 and the true lengths `lens`; counter "iterations") and "dd.readback".
    """
    with spans.span("dd.solve", solver="dd_batch"):
        pr = prep_batch(problems, w=w, th_s=th_s, th_a=th_a, device=device)
        B, P1, P2 = pr["p_z"].shape
        with spans.span("dd.loop", B=B, P1=P1, P2=P2,
                        lens=[list(p[2].shape) for p in problems]):
            core = _dd_core(
                pr, th_s0=float(np.float32(th_s[0])), th_a=float(np.float32(th_a)),
                eta0=float(np.float32(eta0)), t_max=t_max, update_rule=update_rule,
            )
        with spans.span("dd.readback"):
            s, t, violated, x, y, z = (v.cpu().numpy() for v in core)
    out = []
    for b, (_, _, p_z, _, _) in enumerate(problems):
        L1, L2 = p_z.shape
        logger.info("Step: %d, Violated: %d", int(t[b]), int(violated[b]))
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
    `device`: the host work in a span "dd.prep" (attributes P1, P2, U and
    `nw_cells`, each merge's NW cells within its envelope and length), the
    copies in a span "dd.upload" (counter "h2d_bytes")."""
    with spans.span("dd.prep") as sp:
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
        logger.debug("DD batch: B=%d P1=%d P2=%d U=%d", len(problems), P1, P2, U)
        host = {k: np.stack([p[k] for p in preps]) for k in preps[0]}
        if sp is not None:
            sp.attrs.update(P1=P1, P2=P2, U=U, nw_cells=[
                _nw_cells(p["env_first"], p["env_last"], int(p["l1"])) for p in preps])
    dev = torch.device(device)
    with spans.span("dd.upload"):
        spans.count("h2d_bytes", sum(a.nbytes for a in host.values()))
        return {k: torch.from_numpy(a).to(dev) for k, a in host.items()}


def _nw_cells(env_first, env_last, l1: int) -> int:
    """The cells of one merge's banded NW decode as `portbench/roofline.py`
    counts them: those of rows 1..l1 inside the envelope (`env_first`
    clipped to column 1), and one a row."""
    rows = np.arange(1, l1 + 1)
    width = env_last[rows] - np.maximum(env_first[rows], 1) + 1
    return int(np.maximum(width, 0).sum()) + l1


def solve_by_dd(p_x, p_y, p_z, n1, n2, *, w, th_s, th_a, eta0, t_max, device,
                update_rule="subgradient", stats=None):
    """Solve one merge's joint align+fold problem by dual decomposition.

    Args:
      p_x: (L1, L1) averaged base-pair probs of group 1 (dense, cut off).
      p_y: (L2, L2) for group 2.
      p_z: (L1, L2) averaged match probs.
      n1, n2: group sizes.
      th_s: list of fold thresholds (th_s[0] drives the Nussinov decode;
        min(th_s) gates candidates).
    Returns:
      (s, x, y, z) with int64 vectors (-1 = unpaired/unaligned).
    """
    return solve_by_dd_batch(
        [(p_x, p_y, p_z, n1, n2)], w=w, th_s=th_s, th_a=th_a, eta0=eta0,
        t_max=t_max, device=device, update_rule=update_rule, stats=stats,
    )[0]


def _host_decoders(p_z, env, pad_xy, th_a, device):
    """Decoders of one merge for the host loop, on `device`: returns
    (decode_xy, decode_z).  `decode_xy(sm_x, sm_y)` runs both Nussinov
    decodes in one batch of two, padded to the larger of the two padded
    lengths; `decode_z(sm_z)` the banded NW decode.  Both take the
    unpadded score matrices and return (score, ss or al) of the true
    lengths, scores as Python floats of the float32 results.  Padding as in
    `_prep_dd_problem`: multiples of 32 (at least 32), the cells past the
    true lengths scored as the padded zero posteriors and multipliers
    score them (`pad_xy` for the two structure problems); no decoder reads
    them."""
    f = np.float32
    dev = torch.device(device)
    L1, L2 = p_z.shape
    P1, P2 = max(_round_up(L1, 32), 32), max(_round_up(L2, 32), 32)
    P = max(P1, P2)
    lens_xy = torch.tensor([L1, L2], dtype=torch.int32, device=dev)
    envf = np.zeros((1, P1 + 1), np.int32)
    envl = np.zeros((1, P1 + 1), np.int32)
    envf[0, : L1 + 1] = env[:, 0]
    envl[0, : L1 + 1] = env[:, 1]
    envl[0, L1 + 1:] = L2
    envf, envl = torch.from_numpy(envf).to(dev), torch.from_numpy(envl).to(dev)
    l1 = torch.tensor([L1], dtype=torch.int32, device=dev)
    l2 = torch.tensor([L2], dtype=torch.int32, device=dev)
    sm_xy = np.empty((2, P, P), np.float32)
    sm_xy[0], sm_xy[1] = pad_xy
    sm_z = np.full((1, P1, P2), np.float32(f(0.0) - f(th_a)), np.float32)

    def decode_xy(sm_x, sm_y):
        sm_xy[0, :L1, :L1] = sm_x
        sm_xy[1, :L2, :L2] = sm_y
        s, ss = nussinov.decode(torch.from_numpy(sm_xy).to(dev), lens_xy)
        s, ss = s.cpu().numpy(), ss.cpu().numpy()
        return (float(s[0]), ss[0, :L1].astype(np.int64),
                float(s[1]), ss[1, :L2].astype(np.int64))

    def decode_z(sm):
        sm_z[0, :L1, :L2] = sm
        s, al = nw.decode(torch.from_numpy(sm_z).to(dev), envf, envl, l1, l2)
        return float(s.cpu().numpy()[0]), al[0, :L1].cpu().numpy().astype(np.int64)

    return decode_xy, decode_z


@spans.spanned("dd.solve", solver="dd_host")
def solve_by_dd_ipknot(p_x, p_y, p_z, n1, n2, *, w, th_s, th_a, eta0, t_max,
                       device, structure_decoder="ipknot", verbose_cb=None,
                       trace_cb=None):
    """Host-loop DD merge solve with a pluggable structure decoder (port of
    `dafs_tpu.dd.solve_by_dd_ipknot`, src/dafs.cpp:1006-1295).

    structure_decoder="ipknot": the reference's --ipknot mode uses the
    IPknot ILP *inside* the DD loop (s_decoder_, src/dafs.cpp:1754,
    1091-1092); the ILPs run on the host, the NW decode on `device`.
    structure_decoder="nussinov": both structure decodes go to
    `ops/nussinov.decode` on `device` (K3 on the card) in one batch of two,
    as used by the -v 2 verbose mode, where verbose_cb(x, y, z) is invoked
    each iteration (output_verbose, src/dafs.cpp:875-894), and by `dd_host`.
    The NW decode goes to `ops/nw.decode` (K4 on the card).  The multiplier
    arithmetic is numpy float32, written in the JAX package's order, so the
    iterates are its bits; trace_cb(t, s, violated, eta) sees each
    iteration.
    """
    from dafs_tpu_torch.decoders_ip import ipknot

    f = np.float32
    L1, L2 = p_z.shape
    min_th_s = min(th_s)
    cbp = enumerate_cbp(p_x, p_y, p_z, n1, n2, w, min_th_s, th_a)
    env = nw.envelope(p_z, th_a)
    in_cx = np.zeros((L1, L1), bool)
    in_cy = np.zeros((L2, L2), bool)
    in_cz = np.zeros((L1, L2), bool)
    if len(cbp):
        in_cx[cbp[:, 0], cbp[:, 1]] = True
        in_cy[cbp[:, 2], cbp[:, 3]] = True
        in_cz[cbp[:, 0], cbp[:, 2]] = True
        in_cz[cbp[:, 1], cbp[:, 3]] = True

    q_x = np.zeros((L1, L1), np.float32)
    q_y = np.zeros((L2, L2), np.float32)
    q_z = np.zeros((L1, L2), np.float32)
    w_x = f(f(w) * 2 * n1 / (n1 + n2))
    w_y = f(f(w) * 2 * n2 / (n1 + n2))
    # the padded cells' scores, as the batched loop's padded zeros give them
    pads = [np.float32(wv * (f(0.0) - f(th_s[0])) - f(0.0)) for wv in (w_x, w_y)]
    decode_xy, decode_z = _host_decoders(p_z, env, pads, th_a, device)
    if structure_decoder == "ipknot":
        # persistent HiGHS models: variable/constraint skeleton built once,
        # per-iteration solves only update costs/bounds and warm-start from
        # the previous incumbent.  If no direct HiGHS binding is importable
        # (ipknot._highs_core), degrade to the slower but public-API
        # per-iteration decode path.
        try:
            ipk_x = ipknot.IPknotModel(p_x, th_s, w_x, extra=in_cx)
            ipk_y = ipknot.IPknotModel(p_y, th_s, w_y, extra=in_cy)
        except ImportError:
            logger.warning(
                "no HiGHS binding for persistent IPknot models; "
                "falling back to per-iteration ILP decodes"
            )

            class _DecodeShim:
                def __init__(self, p, wv):
                    self.p, self.wv = p, wv

                def solve(self, q):
                    return ipknot.decode(self.p, th_s, w=self.wv, q=q)

            ipk_x = _DecodeShim(p_x, w_x)
            ipk_y = _DecodeShim(p_y, w_y)
    eta = f(eta0)
    c = f(0.0)
    s_prev = f(0.0)
    x = np.full(L1, -1, np.int64)
    y = np.full(L2, -1, np.int64)
    z = np.full(L1, -1, np.int64)
    violated = 0

    with spans.span("dd.loop", decoder=structure_decoder, lens=[[L1, L2]]):
        for t in range(t_max):
            if structure_decoder == "ipknot":
                x, _str1, s1 = ipk_x.solve(q_x)
                y, _str2, s2 = ipk_y.solve(q_y)
            else:
                sm_x = np.float32(w_x * (p_x - f(th_s[0])) - q_x)
                sm_y = np.float32(w_y * (p_y - f(th_s[0])) - q_y)
                s1, x, s2, y = decode_xy(sm_x, sm_y)
            sm_z = np.float32(p_z - f(th_a) + q_z)
            s3, z = decode_z(sm_z)
            if verbose_cb is not None:
                verbose_cb(x, y, z)
            s = f(f(s1) + f(s2) + float(s3))

            t_x = np.zeros((L1, L1), np.int64)
            t_y = np.zeros((L2, L2), np.int64)
            t_z = np.zeros((L1, L2), np.int64)
            if len(cbp):
                s_w = np.float32(
                    q_x[cbp[:, 0], cbp[:, 1]] + q_y[cbp[:, 2], cbp[:, 3]]
                    - q_z[cbp[:, 0], cbp[:, 2]] - q_z[cbp[:, 1], cbp[:, 3]]
                )
                act = s_w > 0.0
                s = f(s + np.sum(s_w[act], dtype=np.float32))
                np.add.at(t_x, (cbp[act, 0], cbp[act, 1]), 1)
                np.add.at(t_y, (cbp[act, 2], cbp[act, 3]), 1)
                np.add.at(t_z, (cbp[act, 0], cbp[act, 2]), 1)
                np.add.at(t_z, (cbp[act, 1], cbp[act, 3]), 1)

            X = np.zeros((L1, L1), np.int64)
            X[np.arange(L1)[x >= 0], x[x >= 0]] = 1
            Y = np.zeros((L2, L2), np.int64)
            Y[np.arange(L2)[y >= 0], y[y >= 0]] = 1
            Z = np.zeros((L1, L2), np.int64)
            Z[np.arange(L1)[z >= 0], z[z >= 0]] = 1

            dx = t_x - X
            ux = ((X > 0) | in_cx) & (dx != 0)
            q_x = np.where(ux, np.float32(q_x - eta * dx.astype(np.float32)), q_x)
            dy = t_y - Y
            uy = ((Y > 0) | in_cy) & (dy != 0)
            q_y = np.where(uy, np.float32(q_y - eta * dy.astype(np.float32)), q_y)
            dz = Z - t_z
            mz = (Z > 0) | in_cz
            q_z = np.where(
                mz, np.maximum(np.float32(0.0), np.float32(q_z - eta * dz.astype(np.float32))), q_z
            )
            vz = ((Z > 0) & (t_z > 1)) | ((Z == 0) & in_cz & (t_z > 0))
            violated = int(ux.sum() + uy.sum() + vz.sum())

            if trace_cb is not None:
                # the reference's per-iteration debug line (src/dafs.cpp:1273-1276):
                # step t, Lagrangian bound s, violation count, eta
                trace_cb(t, float(s), violated, float(eta))
            if violated == 0:
                break
            if s > s_prev or t == 0:
                denom = 4.0 * max(len(cbp), 1)
                c = f(c + max(0.0, f(4.0 * len(cbp)) - violated) / denom)
                eta = f(eta0 / (1.0 + c))
            s_prev = s
        spans.count("iterations", t + 1 if t_max > 0 else 0)

    logger.info("Step: %s, Violated: %d", "ipknot-dd", violated)
    return float(s_prev), x, y, z


@spans.spanned("dd.solve", solver="ip")
def solve_by_ip(p_x, p_y, p_z, n1, n2, *, w, th_s, th_a, eta0=None, t_max=None,
                fix_z=None, device=None):
    """Exact joint ILP (DAFS::solve_by_ip, src/dafs.cpp:1297-1497), reached
    with -m 0.  Variables x_ij, y_kl, z_ik, w_ijkl; constraints: at most one
    partner per base, no pseudoknots, no crossing matches, consensus coupling.
    Solved with scipy's HiGHS milp.

    fix_z: optional set of (i, k) cells; when given, every z variable is
    pinned (1 if in the set, 0 otherwise), to score a known matching.

    A copy of `dafs_tpu.dd.solve_by_ip` (numpy and scipy only, host code
    on every device); `device` is taken for the solvers' common signature
    and not used."""
    from scipy import sparse as sp
    from scipy.optimize import LinearConstraint, milp

    f = np.float32
    L1, L2 = p_z.shape
    min_th_s = f(min(th_s))

    zi, zk = np.nonzero(p_z > CUTOFF)
    v_z = {(i, k): t for t, (i, k) in enumerate(zip(zi, zk))}
    obj = [float(f(p_z[i, k] - f(th_a))) for (i, k) in v_z]

    cbp = enumerate_cbp(p_x, p_y, p_z, n1, n2, w, float(min_th_s), th_a, for_ip=True)
    v_x: dict = {}
    v_y: dict = {}
    v_w = []
    nv = len(v_z)
    for (i, j, k, l) in cbp:
        v_w.append((nv, (i, j, k, l)))
        obj.append(0.0)
        nv += 1
        if (i, j) not in v_x:
            v_x[(i, j)] = nv
            obj.append(float(f(f(w) * (p_x[i, j] - min_th_s))))
            nv += 1
        if (k, l) not in v_y:
            v_y[(k, l)] = nv
            obj.append(float(f(f(w) * (p_y[k, l] - min_th_s))))
            nv += 1

    rows, lbs, ubs = [], [], []

    def add(coeffs, lo, hi):
        rows.append(coeffs)
        lbs.append(lo)
        ubs.append(hi)

    # each base pairs at most once (x)
    for i in range(L1):
        cs = [(v, 1.0) for (a, b), v in v_x.items() if a == i or b == i]
        if cs:
            add(cs, -np.inf, 1.0)
    # no pseudoknots in x
    xk = sorted(v_x)
    for ai in range(len(xk)):
        i, j = xk[ai]
        for bi in range(len(xk)):
            k, l = xk[bi]
            if i < k < j < l:
                add([(v_x[(i, j)], 1.0), (v_x[(k, l)], 1.0)], -np.inf, 1.0)
    # same for y
    for k in range(L2):
        cs = [(v, 1.0) for (a, b), v in v_y.items() if a == k or b == k]
        if cs:
            add(cs, -np.inf, 1.0)
    yk2 = sorted(v_y)
    for ai in range(len(yk2)):
        i, j = yk2[ai]
        for bi in range(len(yk2)):
            k, l = yk2[bi]
            if i < k < j < l:
                add([(v_y[(i, j)], 1.0), (v_y[(k, l)], 1.0)], -np.inf, 1.0)
    # each base aligns at most once
    for i in range(L1):
        cs = [(v, 1.0) for (a, b), v in v_z.items() if a == i]
        if cs:
            add(cs, -np.inf, 1.0)
    for k in range(L2):
        cs = [(v, 1.0) for (a, b), v in v_z.items() if b == k]
        if cs:
            add(cs, -np.inf, 1.0)
    # no crossing matches
    zk2 = sorted(v_z)
    for (i, k) in zk2:
        for (j, l) in zk2:
            if j > i and l < k:
                add([(v_z[(i, k)], 1.0), (v_z[(j, l)], 1.0)], -np.inf, 1.0)
    # consensus coupling: x_ij = sum w over cbp with that (i,j); same for y;
    # z_ik >= sum w touching it
    from collections import defaultdict

    by_x = defaultdict(list)
    by_y = defaultdict(list)
    by_z = defaultdict(list)
    for (vw, (i, j, k, l)) in v_w:
        by_x[(i, j)].append(vw)
        by_y[(k, l)].append(vw)
        by_z[(i, k)].append(vw)
        by_z[(j, l)].append(vw)
    for (ij, ws) in by_x.items():
        add([(v_x[ij], 1.0)] + [(vw, -1.0) for vw in ws], 0.0, 0.0)
    for (kl, ws) in by_y.items():
        add([(v_y[kl], 1.0)] + [(vw, -1.0) for vw in ws], 0.0, 0.0)
    for (ik, ws) in by_z.items():
        if ik in v_z:
            add([(v_z[ik], 1.0)] + [(vw, -1.0) for vw in ws], 0.0, np.inf)
    # x/y pairs not touched by any cbp are fixed 0 by the reference's FX rows
    for ij, v in v_x.items():
        if ij not in by_x:
            add([(v, 1.0)], 0.0, 0.0)
    for kl, v in v_y.items():
        if kl not in by_y:
            add([(v, 1.0)], 0.0, 0.0)

    if fix_z is not None:
        for ik, v in v_z.items():
            val = 1.0 if ik in fix_z else 0.0
            add([(v, 1.0)], val, val)

    if nv == 0:
        return (
            0.0,
            np.full(L1, -1, np.int64),
            np.full(L2, -1, np.int64),
            np.full(L1, -1, np.int64),
        )

    data, ri, ci = [], [], []
    for r, coeffs in enumerate(rows):
        for v, c in coeffs:
            ri.append(r)
            ci.append(v)
            data.append(c)
    A = sp.csr_matrix((data, (ri, ci)), shape=(len(rows), nv))
    res = milp(
        c=-np.array(obj),
        constraints=LinearConstraint(A, np.array(lbs), np.array(ubs)),
        integrality=np.ones(nv),
        bounds=(0, 1),
    )
    sol = res.x > 0.5 if res.x is not None else np.zeros(nv, bool)

    x = np.full(L1, -1, np.int64)
    for (i, j), v in v_x.items():
        if sol[v]:
            x[i] = j
    y = np.full(L2, -1, np.int64)
    for (k, l), v in v_y.items():
        if sol[v]:
            y[k] = l
    z = np.full(L1, -1, np.int64)
    for (i, k), v in v_z.items():
        if sol[v]:
            z[i] = k
    s = float(np.dot(np.array(obj), sol.astype(np.float64)))
    return s, x, y, z
