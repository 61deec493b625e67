"""CUDA kernel K3: batched MEA Nussinov decode with in-kernel traceback.

Replaces the Pallas TPU kernel `dafs_tpu/ops/nussinov_pallas.py::_kernel`;
the source and its design notes are in `csrc/nussinov.cu`.  The plain
PyTorch version is `ops/nussinov.decode_plain`, which `ops/nussinov.decode`
takes for CPU tensors.  This wrapper accepts CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int

DECODE = cuda_lib.CudaKernel(
    "dafs_nussinov_decode", [_P, _P, _P, _P, _P, _P, _P, _I, _I]
)

MAX_L = 1024


def decode(sm: torch.Tensor, lens: torch.Tensor):
    """sm (B, L, L) float32 scores, lens (B,) int32 true lengths (<= L) ->
    (score (B,) float32, ss (B, L) int32)."""
    dev = sm.device
    if dev.type != "cuda":
        raise ValueError(f"nussinov_cuda.decode: expected CUDA tensors, got {dev}")
    B, L, _ = sm.shape
    if not 1 <= L <= MAX_L:
        raise ValueError(f"nussinov_cuda.decode: unsupported padded length {L}")
    cuda_lib.check(sm, "sm", torch.float32, (B, L, L), dev)
    cuda_lib.check(lens, "lens", torch.int32, (B,), dev)
    dl = torch.empty((B, L, L), dtype=torch.float32, device=dev)
    ml = torch.empty((B, L, L), dtype=torch.float32, device=dev)
    code = torch.empty((B, L, L), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    ss = torch.empty((B, L), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    DECODE(p(sm), p(lens), p(dl), p(ml), p(code), p(score), p(ss), B, L)
    return score, ss
