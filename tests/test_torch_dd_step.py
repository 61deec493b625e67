"""The DD step kernels' surroundings on the CPU: what can be checked without
a card.

The kernels of `csrc/dd_step.cu` run only on the card (`tests/test_torch_cuda.py`
and `chip_smoke.py` hold them to the plain step there, bit for bit).  Here:

- a DD loop on the CPU takes the plain step, and the kernels' wrapper
  refuses CPU tensors and launches nothing;
- the ctypes struct has the C struct's fields in its order;
- `emulate`, a numpy transcription of the three kernels (the candidate
  kernel's masked scores and integer counts, `torch.sum` of them, the update
  kernel's per-cell step, score matrices and zeroed counts for running
  merges only, the per-merge kernel), gives the plain step's bits after
  every body, and the score matrices the plain version builds at the start
  of the next, under each update rule, with merges freezing on the way.
"""

import os
import re

import numpy as np
import pytest
import torch

from dafs_tpu_torch import dd
from dafs_tpu_torch.ops import dd_step_cuda, nussinov, nw
from tests.merge_problems import DENSE, KW, PROBLEMS, _dense_problem, _problem

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

CU = os.path.join(os.path.dirname(dd.__file__), "csrc", "dd_step.cu")
F = np.float32
CONSTS = dict(th_s0=float(F(KW["th_s"][0])), th_a=float(F(KW["th_a"])),
              eta0=float(F(KW["eta0"])))


def _pr(problems):
    return dd.prep_batch(problems, w=KW["w"], th_s=KW["th_s"], th_a=KW["th_a"], device="cpu")


def _state(pr, rule, t_max=200):
    return dd._State(pr, t_max=t_max, update_rule=rule, **CONSTS)


def test_struct_matches_the_source():
    """DDStepArgs (ctypes) has csrc/dd_step.cu's fields, in its order, with
    pointers where the source has pointers and floats where it has floats."""
    with open(CU) as fh:
        src = fh.read()
    body = re.search(r"struct DDStepArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            typ, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl, re.S).groups()
            kind = "ptr" if typ.endswith("*") else typ
            fields += [(nm.strip(), kind) for nm in names.split(",")]
    ctype = {"c_void_p": "ptr", "c_float": "float", "c_int": "int"}
    got = [(f, ctype[t.__name__]) for f, t in dd_step_cuda.DDStepArgs._fields_]
    assert got == fields


def test_cpu_loop_takes_the_plain_step():
    """A state on the CPU has no kernels, and the kernels' wrapper refuses
    CPU tensors before launching anything."""
    pr = _pr([(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS[:3]])
    st = _state(pr, "adam")
    assert st.kernels is None
    before = [k.launches for k in (dd_step_cuda.CANDIDATES, dd_step_cuda.UPDATE,
                                    dd_step_cuda.SCALARS)]
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        dd_step_cuda.Step(pr, st)
    dd._body(st)
    assert int(st.t.sum()) == 3
    assert before == [k.launches for k in (dd_step_cuda.CANDIDATES, dd_step_cuda.UPDATE,
                                           dd_step_cuda.SCALARS)]


def _numpy_state(st):
    em = {k: getattr(st, k).numpy().copy() for k, *_ in dd_step_cuda.STATE if k != "sm_z"}
    em["opt"] = [o.numpy().copy() for o in st.opt]
    for k, q in (("t_x", st.q_x), ("t_y", st.q_y), ("t_z", st.q_z)):
        em[k] = np.zeros(q.shape, np.int32)
    _, sm_z = dd._scores_plain(st)
    em["sm_xy"], em["sm_z"] = st.sm_xy.numpy().copy(), sm_z.numpy().copy()
    return em


def _sqrt(a):
    """torch's float32 sqrt on the CPU, as the plain step takes it: its
    vectorised sqrt is not correctly rounded in the last bit for some
    inputs (numpy's, the card's and the kernels' `sqrtf` are)."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def emulate(em, st, s_xy, xy, s_z, z_new):
    """The three step kernels of one body as numpy, on the arrays `em`
    (`_numpy_state`), in the kernels' order and arithmetic."""
    pr, rule, c = st.pr, st.update_rule, {k: F(v) for k, v in st.consts.items()}
    B, P1, P2 = st.B, st.P1, st.P2
    s_xy, xy, s_z, z_new = (v.numpy() for v in (s_xy, xy, s_z, z_new))
    run = [b for b in range(B) if not em["done"][b]]
    bc_tabs = dd._adam_bias_corrections(st.t_max)
    # candidates_kernel
    cbp, valid = pr["cbp"].numpy(), pr["cbp_valid"].numpy()
    sw = np.zeros(valid.shape, F)
    for b in run:
        i, j, k, l = cbp[b].T
        s_w = ((em["q_x"][b, i, j] + em["q_y"][b, k, l]) - em["q_z"][b, i, k]) - em["q_z"][b, j, l]
        act = valid[b] & (s_w > 0)
        sw[b] = np.where(act, s_w, F(0))
        for t, r, q in (("t_x", i, j), ("t_y", k, l), ("t_z", i, k), ("t_z", j, l)):
            np.add.at(em[t][b], (r[act], q[act]), 1)
    s_sum = torch.sum(torch.from_numpy(sw), dim=1).numpy()
    # update_kernel
    viol = np.zeros(B, np.int32)
    planes = (("x", P1, xy[:B, :P1]), ("y", P2, xy[B:, :P2]), ("z", P2, z_new))
    for pi, (name, cols, dec) in enumerate(planes):
        q, cnt = em[f"q_{name}"], em[f"t_{name}"]
        p, inc = pr[f"p_{name}"].numpy(), pr[f"in_c{name}"].numpy()
        for b in run:
            hot = dec[b][:, None] == np.arange(cols)[None, :]
            tc, qv = cnt[b], q[b]
            d = (hot.astype(np.int32) - tc if name == "z" else tc - hot).astype(F)
            mask = hot | inc[b]
            upd = mask & (d != 0)
            if rule == "subgradient":
                step = em["eta"][b] * d
            elif rule == "adagrad":
                g2 = em["opt"][pi]
                g2[b] = np.where(upd, g2[b] + d * d, g2[b])
                step = (c["eta0"] * d) / _sqrt(g2[b] + c["eps"])
            else:
                m, v = em["opt"][pi], em["opt"][3 + pi]
                t = em["t"][b]
                bc1, bc2 = (F(x[t]) for x in bc_tabs)
                m[b] = np.where(upd, c["b1"] * m[b] + (F(1) - c["b1"]) * d, m[b])
                v[b] = np.where(upd, c["b2"] * v[b] + ((F(1) - c["b2"]) * d) * d, v[b])
                step = (c["eta0"] * (m[b] / bc1)) / (_sqrt(v[b] / bc2) + c["eps"])
            if name == "z":
                qn = np.where(mask, np.maximum(qv - np.where(upd, step, F(0)), F(0)), qv)
                viol[b] += ((hot & (tc > 1)) | (~hot & inc[b] & (tc > 0))).sum()
                em["sm_z"][b] = (p[b] - c["th_a"]) + qn
            else:
                qn = np.where(upd, qv - step, qv)
                viol[b] += upd.sum()
                w = pr[f"w_{name}"].numpy()[b]
                row = b if name == "x" else B + b
                em["sm_xy"][row, :cols, :cols] = w * (p[b] - c["th_s0"]) - qn
            q[b], cnt[b] = qn, 0
    # scalars_kernel
    for b in run:
        s = ((s_xy[b] + s_xy[B + b]) + s_z[b]) + s_sum[b]
        done_new = viol[b] == 0
        if rule == "subgradient" and (s > em["s_prev"][b] or em["t"][b] == 0) and not done_new:
            n4 = pr["n_cbp4"].numpy()[b]
            em["c"][b] = em["c"][b] + np.maximum(n4 - F(viol[b]), F(0)) / n4
            em["eta"][b] = c["eta0"] / (F(1) + em["c"][b])
        em["s_prev"][b] = em["s_prev"][b] if done_new else s
        em["violated"][b], em["t"][b], em["done"][b] = viol[b], em["t"][b] + 1, done_new
        em["x"][b], em["y"][b], em["z"][b] = xy[b, :P1], xy[B + b, :P2], z_new[b]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("rule", ["subgradient", "adagrad", "adam"])
@pytest.mark.parametrize("batch", ["problems", "dense"])
def test_emulated_kernels_match_plain_step(batch, rule):
    """After every body the emulated kernels hold the plain step's bits in
    q, the optimiser state, s, t, violated, x, y, z and done, and the score
    matrices of the next body; the count planes are zero again."""
    if batch == "problems":
        problems, bodies = [(*_problem(*p[:3]), *p[3:]) for p in PROBLEMS], 70
    else:
        problems, bodies = [(*_dense_problem(*p[:3]), *p[3:]) for p in DENSE], 12
    st = _state(_pr(problems), rule)
    em = _numpy_state(st)
    for _ in range(bodies):
        sm_xy, sm_z = dd._scores_plain(st)
        assert np.array_equal(_bits(em["sm_xy"]), _bits(sm_xy.numpy()))
        assert np.array_equal(_bits(em["sm_z"]), _bits(sm_z.numpy()))
        s_xy, xy = nussinov.decode(sm_xy, st.lens_xy)
        s_z, z_new = nw.decode(sm_z, st.pr["env_first"], st.pr["env_last"],
                               st.pr["l1"], st.pr["l2"])
        emulate(em, st, s_xy, xy, s_z, z_new)
        dd._step_plain(st, s_xy, xy, s_z, z_new)
        for name, *_ in dd_step_cuda.STATE:
            if name not in ("sm_xy", "sm_z"):
                assert np.array_equal(_bits(em[name]), _bits(getattr(st, name).numpy())), name
        for got, want in zip(em["opt"], st.opt):
            assert np.array_equal(_bits(got), _bits(want.numpy()))
        assert not any(em[t].any() for t in ("t_x", "t_y", "t_z"))
    if batch == "problems":
        assert 0 < int(st.done.sum()) < st.B  # some merges froze, some ran on
    else:
        assert st.P1 != st.P2 and st.pr["cbp"].shape[1] > 256
