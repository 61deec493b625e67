"""CUDA kernels K1 (forward) and K2 (backward) of the ProbCons pair-HMM.

They replace the Pallas TPU kernels `dafs_tpu/ops/pairhmm_pallas.py`
`_fwd_kernel` and `_bwd_kernel`; the source and its design notes are in
`csrc/pairhmm.cu`.  The plain PyTorch versions are
`ops/pairhmm.forward_plain` / `backward_plain`, which `ops/pairhmm.forward`
/ `backward` take for CPU tensors.  These wrappers accept CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I]

FORWARD = cuda_lib.CudaKernel("dafs_pairhmm_forward", _ARGS)
BACKWARD = cuda_lib.CudaKernel("dafs_pairhmm_backward", _ARGS)

MAX_IMAX = 1024  # one block of at most 1024 threads walks a diagonal


def pack_tables(tab: dict) -> torch.Tensor:
    """[match (7x7), ins (7), trans (3x3), init (3)] as one float32 vector,
    the layout csrc/pairhmm.cu stages in shared memory."""
    return torch.cat([
        tab["match"].reshape(-1), tab["ins"].reshape(-1),
        tab["trans"].reshape(-1), tab["init"].reshape(-1),
    ]).contiguous()


def _run(kernel, codes1, len1, codes2, len2, tab, ncap):
    dev = codes1.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel.symbol}: expected CUDA tensors, got {dev}")
    B, imax = codes1.shape
    W = codes2.shape[1]
    if not 2 <= imax <= MAX_IMAX or W < 2:
        raise ValueError(f"{kernel.symbol}: unsupported padded lengths {imax - 1}, {W - 1}")
    cuda_lib.check(codes1, "codes1", torch.int32, (B, imax), dev)
    cuda_lib.check(codes2, "codes2", torch.int32, (B, W), dev)
    cuda_lib.check(len1, "len1", torch.int32, (B,), dev)
    cuda_lib.check(len2, "len2", torch.int32, (B,), dev)
    packed = pack_tables(tab)
    cuda_lib.check(packed, "tables", torch.float32, (68,), dev)
    out = torch.empty((B, imax, W), dtype=torch.float32, device=dev)
    cap = torch.zeros((B, ncap), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    kernel(p(codes1), p(len1), p(codes2), p(len2), p(packed), p(out), p(cap),
           B, imax, W - 1)
    return out, cap


def forward(codes1, len1, codes2, len2, tab):
    """Kernel K1: (fm (B, l1max+1, l2max+1), fcap (B, 6)); see ops/pairhmm."""
    return _run(FORWARD, codes1, len1, codes2, len2, tab, 6)


def backward(codes1, len1, codes2, len2, tab):
    """Kernel K2: (bm (B, l1max+1, l2max+1), bcap (B, 3)); see ops/pairhmm."""
    return _run(BACKWARD, codes1, len1, codes2, len2, tab, 3)
