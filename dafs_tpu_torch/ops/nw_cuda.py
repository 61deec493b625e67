"""CUDA kernel K4: batched banded MEA Needleman-Wunsch decode with in-kernel
traceback.

Replaces the Pallas TPU kernel `dafs_tpu/ops/nw_pallas.py::_kernel`; the
source and its design notes are in `csrc/nw.cu`.  The plain PyTorch version
is `ops/nw.decode_plain`, which `ops/nw.decode` takes for CPU tensors.  This
wrapper accepts CUDA tensors only.

The kernel of the main path takes L2 + 1 <= `MAX_COLS` columns, and its
shared memory, a ring of score rows and the traceback codes at 2 bits a
cell, must fit one block: `smem_bytes(L1, L2)` <= `MAX_SMEM_BYTES` (L1 <=
1703 at L2 = 320, 771 at L2 = 1023).  Every other shape up to `CEILING`
rows and columns goes to its long variant `DECODE_LONG` (a block of 1024
threads row by row, codes one byte a cell in global memory: 16 MB a
problem at 4096 x 4096).  The choice depends on the shape only.  Above
`CEILING` in either dimension the wrapper raises `ValueError`.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int

DECODE = cuda_lib.CudaKernel(
    "dafs_nw_decode", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)

DECODE_LONG = cuda_lib.CudaKernel(
    "dafs_nw_decode_long", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)

MAX_COLS = 1024  # 32 lanes of at most 32 columns each
CEILING = 4096
MAX_SMEM_BYTES = 232448  # shared memory a block can use on Hopper (csrc/common.cuh)


def smem_bytes(L1: int, L2: int) -> int:
    """Shared memory of csrc/nw.cu at this padded shape: each of 32 lanes
    owns CH = ceil((L2+1)/32) columns, rounded up to a multiple of 4; a
    ring of 8 steps of scores (32*CH floats) and envelopes (32 int pairs),
    then L1+1 rows of codes, ceil(CH/16) 32-bit words a lane."""
    ch = -(-(L2 + 1) // 32)
    ch = -(-ch // 4) * 4
    return 8 * 32 * ch * 4 + 8 * 32 * 8 + (L1 + 1) * 32 * 4 * -(-ch // 16)


def decode(sm, env_first, env_last, l1, l2):
    """sm (B, L1, L2) float32, env_first/env_last (B, L1+1) int32, l1/l2
    (B,) int32 -> (score (B,) float32, al (B, L1) int32)."""
    dev = sm.device
    if dev.type != "cuda":
        raise ValueError(f"nw_cuda.decode: expected CUDA tensors, got {dev}")
    B, L1, L2 = sm.shape
    if L1 > CEILING or L2 > CEILING:
        raise ValueError(
            f"nw_cuda.decode: padded shape {L1}x{L2} is above the ceiling of "
            f"{CEILING}x{CEILING}")
    if L1 < 1 or L2 < 1:
        raise ValueError(f"nw_cuda.decode: unsupported padded shape {L1}x{L2}")
    cuda_lib.check(sm, "sm", torch.float32, (B, L1, L2), dev)
    cuda_lib.check(env_first, "env_first", torch.int32, (B, L1 + 1), dev)
    cuda_lib.check(env_last, "env_last", torch.int32, (B, L1 + 1), dev)
    cuda_lib.check(l1, "l1", torch.int32, (B,), dev)
    cuda_lib.check(l2, "l2", torch.int32, (B,), dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    al = torch.empty((B, L1), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):  # the launch goes to this card's stream
        if is_long(L1, L2):
            code = torch.empty((B, L1 + 1, L2 + 1), dtype=torch.uint8, device=dev)
            DECODE_LONG(p(sm), p(env_first), p(env_last), p(l1), p(l2), p(score), p(al),
                        p(code), B, L1, L2)
        else:
            DECODE(p(sm), p(env_first), p(env_last), p(l1), p(l2), p(score), p(al),
                   B, L1, L2)
    return score, al


def is_long(L1: int, L2: int) -> bool:
    """Whether a padded shape goes to the long variant: more than
    `MAX_COLS` columns, or codes beyond one block's shared memory."""
    return L2 + 1 > MAX_COLS or smem_bytes(L1, L2) > MAX_SMEM_BYTES
