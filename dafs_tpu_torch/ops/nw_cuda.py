"""CUDA kernel K4: batched banded MEA Needleman-Wunsch decode with in-kernel
traceback.

Replaces the Pallas TPU kernel `dafs_tpu/ops/nw_pallas.py::_kernel`; the
source and its design notes are in `csrc/nw.cu`.  The plain PyTorch version
is `ops/nw.decode_plain`, which `ops/nw.decode` takes for CPU tensors.  This
wrapper accepts CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int

DECODE = cuda_lib.CudaKernel(
    "dafs_nw_decode", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)

MAX_COLS = 1024  # one thread per column k in [0, L2]


def decode(sm, env_first, env_last, l1, l2):
    """sm (B, L1, L2) float32, env_first/env_last (B, L1+1) int32, l1/l2
    (B,) int32 -> (score (B,) float32, al (B, L1) int32)."""
    dev = sm.device
    if dev.type != "cuda":
        raise ValueError(f"nw_cuda.decode: expected CUDA tensors, got {dev}")
    B, L1, L2 = sm.shape
    if L1 < 1 or not 1 <= L2 + 1 <= MAX_COLS:
        raise ValueError(f"nw_cuda.decode: unsupported padded shape {L1}x{L2}")
    cuda_lib.check(sm, "sm", torch.float32, (B, L1, L2), dev)
    cuda_lib.check(env_first, "env_first", torch.int32, (B, L1 + 1), dev)
    cuda_lib.check(env_last, "env_last", torch.int32, (B, L1 + 1), dev)
    cuda_lib.check(l1, "l1", torch.int32, (B,), dev)
    cuda_lib.check(l2, "l2", torch.int32, (B,), dev)
    tr = torch.empty((B, L1 + 1, L2 + 1), dtype=torch.uint8, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    al = torch.empty((B, L1), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    DECODE(p(sm), p(env_first), p(env_last), p(l1), p(l2), p(tr), p(score),
           p(al), B, L1, L2)
    return score, al
