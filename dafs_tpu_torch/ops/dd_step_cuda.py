"""CUDA kernels of the batched DD loop's multiplier step (`csrc/dd_step.cu`).

They replace no Pallas kernel: XLA fused this part of
`dafs_tpu/dd.py::_dd_core`'s while_loop; the source and its design notes are
in `csrc/dd_step.cu`.  The
plain PyTorch version is `dd._step_plain`, which `dd._step` takes for CPU
tensors.  This wrapper accepts CUDA tensors only.

`Step(pr, st)` binds the kernels to one DD loop: `pr` from `dd.prep_batch`,
`st` a `dd._State`, whose tensors the kernels then update in place (so their
addresses go into one `DDStepArgs` once).  Each call runs one body's step
from that body's decodes: the candidate kernel, one `torch.sum`, the update
kernel and the per-merge kernel, and writes the next body's score matrices
into `st.sm_xy` and `st.sm_z`.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p

CANDIDATES = cuda_lib.CudaKernel("dafs_dd_candidates", [_P])
UPDATE = cuda_lib.CudaKernel("dafs_dd_update", [_P, _P, _P])
SCALARS = cuda_lib.CudaKernel("dafs_dd_scalars", [_P, _P, _P, _P, _P, _P])

RULES = ("subgradient", "adagrad", "adam")  # the source's Rule values, in order
# `prep_batch`'s tensors the kernels read: name, dtype, shape kind
PROBLEM = (
    ("p_x", torch.float32, "x"), ("p_y", torch.float32, "y"), ("p_z", torch.float32, "z"),
    ("in_cx", torch.bool, "x"), ("in_cy", torch.bool, "y"), ("in_cz", torch.bool, "z"),
    ("cbp", torch.int64, "cbp"), ("cbp_valid", torch.bool, "u"),
    ("w_x", torch.float32, "b"), ("w_y", torch.float32, "b"), ("n_cbp4", torch.float32, "b"),
)
# `_State`'s tensors the kernels update in place
STATE = (
    ("q_x", torch.float32, "x"), ("q_y", torch.float32, "y"), ("q_z", torch.float32, "z"),
    ("eta", torch.float32, "b"), ("c", torch.float32, "b"), ("s_prev", torch.float32, "b"),
    ("violated", torch.int64, "b"), ("t", torch.int64, "b"),
    ("x", torch.int32, "bx"), ("y", torch.int32, "by"), ("z", torch.int32, "bx"),
    ("done", torch.bool, "b"), ("sm_xy", torch.float32, "xy"), ("sm_z", torch.float32, "z"),
)
OPT = ("a_x", "a_y", "a_z", "v_x", "v_y", "v_z")  # `_State.opt`, in its order
SCRATCH = ("t_x", "t_y", "t_z", "sw", "viol")
FLOATS = ("th_s0", "th_a", "eta0", "eps", "b1", "b2")
INTS = ("B", "P1", "P2", "P", "U", "rule")


class DDStepArgs(ctypes.Structure):
    """`csrc/dd_step.cu`'s DDStepArgs: the pointers, the floats, the ints."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f, *_ in PROBLEM]
        + [(f, ctypes.c_void_p) for f in ("bc1", "bc2")]
        + [(f, ctypes.c_void_p) for f, *_ in STATE[:3]]
        + [(f, ctypes.c_void_p) for f in OPT]
        + [(f, ctypes.c_void_p) for f, *_ in STATE[3:]]
        + [(f, ctypes.c_void_p) for f in SCRATCH]
        + [(f, ctypes.c_float) for f in FLOATS]
        + [(f, ctypes.c_int) for f in INTS]
    )


def _shapes(B, P1, P2, U):
    P = max(P1, P2)
    return {"x": (B, P1, P1), "y": (B, P2, P2), "z": (B, P1, P2), "b": (B,), "u": (B, U),
            "cbp": (B, U, 4), "bx": (B, P1), "by": (B, P2), "xy": (2 * B, P, P)}


class Step:
    """The step kernels bound to one DD loop's problem `pr` and state `st`
    (see the module docstring).  Raises `ValueError` unless every tensor
    is a contiguous CUDA tensor of the dtype and shape the kernels take."""

    def __init__(self, pr: dict, st):
        dev = pr["p_x"].device
        if dev.type != "cuda":
            raise ValueError(f"dd_step_cuda.Step: expected CUDA tensors, got {dev}")
        rule = RULES.index(st.update_rule)
        B, P1, P2 = pr["p_z"].shape
        U = pr["cbp"].shape[1]
        if not 1 <= B <= 65535:
            raise ValueError(f"dd_step_cuda.Step: {B} merges in one batch")
        shape = _shapes(B, P1, P2, U)
        for name, dtype, kind in PROBLEM:
            cuda_lib.check(pr[name], name, dtype, shape[kind], dev)
        for name, dtype, kind in STATE:
            cuda_lib.check(getattr(st, name), name, dtype, shape[kind], dev)
        n_opt = (0, 3, 6)[rule]
        if len(st.opt) != n_opt:
            raise ValueError(f"{st.update_rule}: expected {n_opt} optimiser planes")
        for name, o in zip(OPT, st.opt):
            cuda_lib.check(o, name, torch.float32, shape[name[-1]], dev)
        bc = (st.bc1_tab, st.bc2_tab) if RULES[rule] == "adam" else ()
        for name, tab in zip(("bc1", "bc2"), bc):
            cuda_lib.check(tab, name, torch.float32, (max(st.t_max, 1),), dev)
        self.dev, self.B, self.P, self.P1 = dev, B, max(P1, P2), P1
        self.scratch = {
            "t_x": torch.zeros(shape["x"], dtype=torch.int32, device=dev),
            "t_y": torch.zeros(shape["y"], dtype=torch.int32, device=dev),
            "t_z": torch.zeros(shape["z"], dtype=torch.int32, device=dev),
            "sw": torch.empty((B, U), dtype=torch.float32, device=dev),
            "viol": torch.zeros((B,), dtype=torch.int32, device=dev),
        }
        # the tensors whose addresses the struct holds stay referenced here
        # (not `st` itself, which holds this object)
        self.keep = ([pr[name] for name, *_ in PROBLEM]
                     + [getattr(st, name) for name, *_ in STATE] + list(st.opt) + list(bc))
        p = cuda_lib.ptr
        a = DDStepArgs()
        for name, *_ in PROBLEM:
            setattr(a, name, p(pr[name]).value)
        for name, tab in zip(("bc1", "bc2"), bc):
            setattr(a, name, p(tab).value)
        for name, *_ in STATE:
            setattr(a, name, p(getattr(st, name)).value)
        for name, o in zip(OPT, st.opt):
            setattr(a, name, p(o).value)
        for name in SCRATCH:
            setattr(a, name, p(self.scratch[name]).value)
        for name in FLOATS:  # float32 values, as the plain version's tensors hold them
            setattr(a, name, st.consts[name])
        a.B, a.P1, a.P2, a.P, a.U = B, P1, P2, self.P, U
        a.rule = rule
        self.args = a
        self.bodies = 0

    def __call__(self, s_xy, xy, s_z, z_new) -> None:
        """One body's step from its decodes: K3's (s_xy (2B,) float32,
        xy (2B, P) int32) and K4's (s_z (B,) float32, z_new (B, P1)
        int32)."""
        B, dev = self.B, self.dev
        cuda_lib.check(s_xy, "s_xy", torch.float32, (2 * B,), dev)
        cuda_lib.check(xy, "xy", torch.int32, (2 * B, self.P), dev)
        cuda_lib.check(s_z, "s_z", torch.float32, (B,), dev)
        cuda_lib.check(z_new, "z_new", torch.int32, (B, self.P1), dev)
        p, args = cuda_lib.ptr, ctypes.byref(self.args)
        with torch.cuda.device(dev):  # the launches go to this card's stream
            CANDIDATES(args)
            s_sum = torch.sum(self.scratch["sw"], dim=1)
            UPDATE(args, p(xy), p(z_new))
            SCALARS(args, p(s_xy), p(xy), p(s_z), p(s_sum), p(z_new))
        self.bodies += 1
