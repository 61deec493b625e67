"""CUDA kernel K3: batched MEA Nussinov decode with in-kernel traceback.

Replaces the Pallas TPU kernel `dafs_tpu/ops/nussinov_pallas.py::_kernel`;
the source and its design notes are in `csrc/nussinov.cu`.  The plain
PyTorch version is `ops/nussinov.decode_plain`, which `ops/nussinov.decode`
takes for CPU tensors.  This wrapper accepts CUDA tensors only.

Each problem runs on a thread-block cluster of `cluster_size(B, L)` CTAs.
Up to padded length `MAX_L` the kernel of the main path runs: the dp and
pair tables and the int16 traceback codes stay in the cluster's shared
memory where they fit (tables up to L = 669, codes beside them up to
L = 389, at 8 CTAs) and go to global memory above that.  Above `MAX_L`, up
to `CEILING`, its long variant `DECODE_LONG` runs instead: tables and int32
codes in global memory (at 4096: 64 MB each table and 32 MB of codes a
problem).  The choice depends on L only.  Above `CEILING` the wrapper
raises `ValueError`.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int

DECODE = cuda_lib.CudaKernel(
    "dafs_nussinov_decode", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)
DECODE_LONG = cuda_lib.CudaKernel(
    "dafs_nussinov_decode_long", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)
FLOOR_PROBE = cuda_lib.CudaKernel("dafs_nussinov_floor_probe", [_P, _I, _I])

MAX_L = 1024
CEILING = 4096
SMS = 132  # streaming multiprocessors of an H100 SXM
WARPS_PER_CTA = 32  # csrc/nussinov.cu kThreads / 32


def cluster_size(B: int, L: int) -> int:
    """CTAs per problem.  One up to L = 128: its 32 warps cover the widest
    diagonal (at most 64 cells), and a block barrier between diagonals
    replaces the far dearer cluster barrier.  Above that, enough warps to
    give each cell of the widest diagonal (about L/2 cells) a warp of its
    own, at most 8 (the portable cluster size), and no more than keeps
    B * C within the card's SMs."""
    if L <= 128:
        return 1
    want = -(-(L // 2) // WARPS_PER_CTA)
    c = 1
    while c < 8 and c < want and B * 2 * c <= SMS:
        c *= 2
    return c


def decode(sm: torch.Tensor, lens: torch.Tensor):
    """sm (B, L, L) float32 scores, lens (B,) int32 true lengths (<= L) ->
    (score (B,) float32, ss (B, L) int32)."""
    dev = sm.device
    if dev.type != "cuda":
        raise ValueError(f"nussinov_cuda.decode: expected CUDA tensors, got {dev}")
    B, L, _ = sm.shape
    if L > CEILING:
        raise ValueError(
            f"nussinov_cuda.decode: padded length {L} is above the ceiling of {CEILING}")
    if L < 1:
        raise ValueError(f"nussinov_cuda.decode: unsupported padded length {L}")
    cuda_lib.check(sm, "sm", torch.float32, (B, L, L), dev)
    cuda_lib.check(lens, "lens", torch.int32, (B,), dev)
    long = L > MAX_L
    dp = torch.empty((B, L, L), dtype=torch.float32, device=dev)
    mt = torch.empty((B, L, L), dtype=torch.float32, device=dev)
    code = torch.empty((B, L * (L - 1) // 2), dtype=torch.int32 if long else torch.int16,
                       device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    ss = torch.empty((B, L), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):  # the launch goes to this card's stream
        (DECODE_LONG if long else DECODE)(p(sm), p(lens), p(dp), p(mt), p(code), p(score),
                                          p(ss), B, L, cluster_size(B, L))
    return score, ss


def floor_probe(buf: torch.Tensor, steps: int, cluster: int) -> None:
    """Launch the K3 design's floor alone on one cluster: `steps` cluster
    barriers, each after one dependent L2 read and write (csrc/nussinov.cu
    floor_probe_kernel).  For timing; it computes nothing of use.  `buf`:
    float32 CUDA scratch of 64 * 32 values."""
    cuda_lib.check(buf, "buf", torch.float32, (64 * 32,), buf.device)
    with torch.cuda.device(buf.device):
        FLOOR_PROBE(cuda_lib.ptr(buf), steps, cluster)

