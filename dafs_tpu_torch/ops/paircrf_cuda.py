"""CUDA kernels of the CONTRAlign pair-CRF: the forward pass, the backward
pass and the posterior kernel behind them.

They replace the plain PyTorch body of `ops/paircrf.forward_backward_posterior_plain`
on the card (a Python loop over the anti-diagonals, some 1160 launches a
diagonal), which `ops/paircrf` keeps for CPU tensors; the source and its
design notes are in `csrc/paircrf.cu`.  The kernels are bit-equal to the
plain version on the card.  These wrappers accept CUDA tensors only.

`forward_backward_posterior` is the main path: base codes to masked match
posteriors in three launches and no other device work.  The backward pass
goes to a side stream and the forward pass to the current one, so the two
passes of every pair run side by side; the posterior kernel follows on the
current stream once both are done.

Limits, chosen by shape only: a pass's block holds a row a lane, at most
1024 threads.  Up to `imax` = l1max + 1 <= `MAX_IMAX` rows it walks one
strip of rows; above that, up to `CEILING` rows, strips of 1024 rows, one
after another, the edge row handed over through a buffer in global memory
that the wrapper allocates.  Above `CEILING` rows the wrappers raise
`ValueError`.  l2max + 1 <= `MAX_COLS` columns: codes2, the hand-over
slots and the tables must fit 48 KB of shared memory.  The posterior
kernel has no row limit.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int

FORWARD = cuda_lib.CudaKernel("dafs_paircrf_forward", [_P] * 10 + [_I] * 3)
BACKWARD = cuda_lib.CudaKernel("dafs_paircrf_backward", [_P] * 10 + [_I] * 3)
POSTERIOR = cuda_lib.CudaKernel("dafs_paircrf_posterior", [_P] * 11 + [_I] * 3)
FLOOR_PROBE = cuda_lib.CudaKernel("dafs_paircrf_floor_probe", [_P, _I, _I, _I])

MAX_IMAX = 1024
CEILING = 4096
MAX_COLS = 8000

_SIDE_STREAMS: dict = {}  # card index -> the stream the backward pass runs on

_TABLE_SHAPES = (("match", (5, 5)), ("ins", (5,)), ("single", (5,)), ("pair", (5, 5)))


def warps(imax: int) -> int:
    """Warps of a pass's block: a row a lane."""
    return -(-imax // 32)


def _check(name, codes1, len1, codes2, len2, tab):
    """Validates the inputs of a pass; returns (B, imax, W, the pointers of
    codes1, len1, codes2, len2 and the four tables in the order
    csrc/paircrf.cu takes them)."""
    dev = codes1.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    B, imax = codes1.shape
    W = codes2.shape[1]
    if imax > CEILING:
        raise ValueError(
            f"{name}: padded length {imax - 1} has {imax} rows, above the "
            f"ceiling of {CEILING}")
    if imax < 2 or not 2 <= W <= MAX_COLS:
        raise ValueError(f"{name}: unsupported padded lengths {imax - 1}, {W - 1}")
    cuda_lib.check(codes1, "codes1", torch.int32, (B, imax), dev)
    cuda_lib.check(codes2, "codes2", torch.int32, (B, W), dev)
    cuda_lib.check(len1, "len1", torch.int32, (B,), dev)
    cuda_lib.check(len2, "len2", torch.int32, (B,), dev)
    for key, shape in _TABLE_SHAPES:
        cuda_lib.check(tab[key], key, torch.float32, shape, dev)
    p = cuda_lib.ptr
    ptrs = (p(codes1), p(len1), p(codes2), p(len2), *(p(tab[key]) for key, _ in _TABLE_SHAPES))
    return B, imax, W, ptrs


def _launch(kernel, ptrs, out, B, imax, W):
    """One pass; above `MAX_IMAX` rows with the buffer for the hand-over
    between strips (two rows of W entries of 8 float32 a pair)."""
    edge = None
    if imax > MAX_IMAX:
        edge = torch.empty((B, 2, W, 8), dtype=torch.float32, device=out.device)
    kernel(*ptrs, cuda_lib.ptr(out), None if edge is None else cuda_lib.ptr(edge),
           B, imax, W - 1)


def forward(codes1, len1, codes2, len2, tab):
    """The forward pass: F (B, 5, l1max + 1, l2max + 1), every state of
    every cell within the true lengths; cells outside them are not
    written."""
    B, imax, W, ptrs = _check(FORWARD.symbol, codes1, len1, codes2, len2, tab)
    dev = codes1.device
    with torch.cuda.device(dev):
        out = torch.empty((B, 5, imax, W), dtype=torch.float32, device=dev)
        _launch(FORWARD, ptrs, out, B, imax, W)
    return out


def backward(codes1, len1, codes2, len2, tab):
    """The backward pass: the M state (B, l1max + 1, l2max + 1) of every
    cell within the true lengths; cells outside them are not written."""
    B, imax, W, ptrs = _check(BACKWARD.symbol, codes1, len1, codes2, len2, tab)
    dev = codes1.device
    with torch.cuda.device(dev):
        out = torch.empty((B, imax, W), dtype=torch.float32, device=dev)
        _launch(BACKWARD, ptrs, out, B, imax, W)
    return out


def posterior(F, Bm, codes1, len1, codes2, len2, tab):
    """The posterior kernel: Z from F's end cell, then clamp(sum over the
    states of Fast_Exp(F + ScoreMatch + Bm - Z), 0, 1) masked to the true
    lengths, (B, l1max, l2max).  Reads F and Bm inside the lengths only."""
    B, imax, W, ptrs = _check(POSTERIOR.symbol, codes1, len1, codes2, len2, tab)
    dev = codes1.device
    cuda_lib.check(F, "F", torch.float32, (B, 5, imax, W), dev)
    cuda_lib.check(Bm, "Bm", torch.float32, (B, imax, W), dev)
    with torch.cuda.device(dev):
        return _posterior(F, Bm, ptrs, B, imax, W)


def _posterior(F, Bm, ptrs, B, imax, W):
    post = torch.empty((B, imax - 1, W - 1), dtype=torch.float32, device=F.device)
    p = cuda_lib.ptr
    POSTERIOR(p(F), p(Bm), *ptrs, p(post), B, imax, W - 1)
    return post


def forward_backward_posterior(codes1, len1, codes2, len2, tab):
    """Base codes to masked match posteriors (B, l1max, l2max): the backward
    pass on a side stream beside the forward pass on the current one, then
    the posterior kernel.  All buffers are allocated on the current stream
    before the side stream starts and are next used after it has been
    waited for.  The tensors' card is made the current one for the
    launches, so that all three go to its streams."""
    B, imax, W, ptrs = _check("paircrf_cuda.forward_backward_posterior",
                              codes1, len1, codes2, len2, tab)
    dev = codes1.device
    with torch.cuda.device(dev):
        F = torch.empty((B, 5, imax, W), dtype=torch.float32, device=dev)
        Bm = torch.empty((B, imax, W), dtype=torch.float32, device=dev)
        cur = torch.cuda.current_stream()
        index = torch.cuda.current_device()
        side = _SIDE_STREAMS.get(index)
        if side is None:
            side = _SIDE_STREAMS[index] = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _launch(BACKWARD, ptrs, Bm, B, imax, W)
        _launch(FORWARD, ptrs, F, B, imax, W)
        cur.wait_stream(side)
        return _posterior(F, Bm, ptrs, B, imax, W)


def floor_probe(buf: torch.Tensor, steps: int, nwarps: int, B: int) -> None:
    """Launches the dependency-floor probe of csrc/paircrf.cu: B blocks of
    `nwarps` warps walk `steps` diagonals, each the backward M chain of one
    cell (four dependent log-adds) after the design's hand-over.  For
    timing; it computes nothing of use.  `buf`: at least B * 32 * nwarps
    float32 on the card."""
    cuda_lib.check(buf, "buf", torch.float32, buf.shape, buf.device)
    if buf.device.type != "cuda" or buf.numel() < B * 32 * nwarps:
        raise ValueError("paircrf_cuda.floor_probe: buf too small or not on the card")
    with torch.cuda.device(buf.device):
        FLOOR_PROBE(cuda_lib.ptr(buf), steps, nwarps, B)
