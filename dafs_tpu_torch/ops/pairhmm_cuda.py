"""CUDA kernels of the ProbCons pair-HMM: K1 (forward), K2 (backward) and
the posterior kernel behind them.

They replace the Pallas TPU kernels `dafs_tpu/ops/pairhmm_pallas.py`
`_fwd_kernel` and `_bwd_kernel` and the posterior step XLA fused behind them
(`pairhmm_pallas.py:484-508`); the source and its design notes are in
`csrc/pairhmm.cu`.  The plain PyTorch versions are `ops/pairhmm.forward_plain`,
`backward_plain` and `posterior`, which `ops/pairhmm` takes for CPU tensors.
These wrappers accept CUDA tensors only.

`forward_backward_posterior` is the main path: base codes to masked match
posteriors in three launches and no other device work.  K2 goes to a side
stream and K1 to the current one, so the two passes of every pair run side
by side; the posterior kernel follows on the current stream once both are
done.

Limit: `imax` = l1max + 1 <= `MAX_IMAX` rows (a block of at most 1024
threads, a row a lane), and l2max + 1 <= `MAX_COLS` columns: codes2, the
hand-over slots and the tables must fit 48 KB of shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from dafs_tpu_torch.ops import cuda_lib

_P = ctypes.c_void_p
_I = ctypes.c_int
_PASS_ARGS = [_P] * 10 + [_I] * 3

FORWARD = cuda_lib.CudaKernel("dafs_pairhmm_forward", _PASS_ARGS)
BACKWARD = cuda_lib.CudaKernel("dafs_pairhmm_backward", _PASS_ARGS)
POSTERIOR = cuda_lib.CudaKernel(
    "dafs_pairhmm_posterior", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)
FLOOR_PROBE = cuda_lib.CudaKernel("dafs_pairhmm_floor_probe", [_P, _I, _I, _I])

MAX_IMAX = 1024
MAX_COLS = 8000

_SIDE_STREAMS: dict = {}  # card index -> the stream K2 runs on


def warps(imax: int) -> int:
    """Warps of a pass's block: a row a lane."""
    return -(-imax // 32)


_TABLE_SHAPES = (("match", (7, 7)), ("ins", (7,)), ("trans", (3, 3)), ("init", (3,)))


def table_ptrs(tab: dict, dev) -> tuple:
    """Device pointers of the four tables in the order csrc/pairhmm.cu takes
    them, after checking each."""
    for name, shape in _TABLE_SHAPES:
        cuda_lib.check(tab[name], name, torch.float32, shape, dev)
    return tuple(cuda_lib.ptr(tab[name]) for name, _ in _TABLE_SHAPES)


def _check(name, codes1, len1, codes2, len2, tab):
    """Validates the inputs of a pass; returns (B, imax, W, table pointers)."""
    dev = codes1.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    B, imax = codes1.shape
    W = codes2.shape[1]
    if not 2 <= imax <= MAX_IMAX or not 2 <= W <= MAX_COLS:
        raise ValueError(f"{name}: unsupported padded lengths {imax - 1}, {W - 1}")
    cuda_lib.check(codes1, "codes1", torch.int32, (B, imax), dev)
    cuda_lib.check(codes2, "codes2", torch.int32, (B, W), dev)
    cuda_lib.check(len1, "len1", torch.int32, (B,), dev)
    cuda_lib.check(len2, "len2", torch.int32, (B,), dev)
    return B, imax, W, table_ptrs(tab, dev)


def _run(kernel, codes1, len1, codes2, len2, tab, ncap):
    B, imax, W, tabs = _check(kernel.symbol, codes1, len1, codes2, len2, tab)
    dev = codes1.device
    out = torch.empty((B, imax, W), dtype=torch.float32, device=dev)
    cap = torch.empty((B, ncap), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        kernel(p(codes1), p(len1), p(codes2), p(len2), *tabs, p(out), p(cap),
               B, imax, W - 1)
    return out, cap


def forward(codes1, len1, codes2, len2, tab):
    """Kernel K1: (fm (B, l1max+1, l2max+1), fcap (B, 6)); see ops/pairhmm."""
    return _run(FORWARD, codes1, len1, codes2, len2, tab, 6)


def backward(codes1, len1, codes2, len2, tab):
    """Kernel K2: (bm (B, l1max+1, l2max+1), bcap (B, 3)); see ops/pairhmm."""
    return _run(BACKWARD, codes1, len1, codes2, len2, tab, 3)


def posterior(fm, fcap, bm, bcap, len1, len2, tab):
    """The posterior kernel: totals from the captures, then
    probcons_exp(min(0, fm + bm - total)) masked to the true lengths,
    (B, l1max, l2max).  Reads fm and bm inside the true lengths only."""
    dev = fm.device
    if dev.type != "cuda":
        raise ValueError(f"{POSTERIOR.symbol}: expected CUDA tensors, got {dev}")
    B, imax, W = fm.shape
    if imax < 2 or W < 2:
        raise ValueError(f"{POSTERIOR.symbol}: unsupported padded lengths {imax - 1}, {W - 1}")
    cuda_lib.check(fm, "fm", torch.float32, (B, imax, W), dev)
    cuda_lib.check(bm, "bm", torch.float32, (B, imax, W), dev)
    cuda_lib.check(fcap, "fcap", torch.float32, (B, 6), dev)
    cuda_lib.check(bcap, "bcap", torch.float32, (B, 3), dev)
    cuda_lib.check(len1, "len1", torch.int32, (B,), dev)
    cuda_lib.check(len2, "len2", torch.int32, (B,), dev)
    cuda_lib.check(tab["init"], "init", torch.float32, (3,), dev)
    with torch.cuda.device(dev):
        return _posterior(fm, fcap, bm, bcap, len1, len2, tab["init"])


def _posterior(fm, fcap, bm, bcap, len1, len2, init):
    B, imax, W = fm.shape
    post = torch.empty((B, imax - 1, W - 1), dtype=torch.float32, device=fm.device)
    p = cuda_lib.ptr
    POSTERIOR(p(fm), p(fcap), p(bm), p(bcap), p(len1), p(len2), p(init), p(post),
              B, imax, W - 1)
    return post


def forward_backward_posterior(codes1, len1, codes2, len2, tab):
    """Base codes to masked match posteriors (B, l1max, l2max): K2 on a side
    stream beside K1 on the current one, then the posterior kernel.  All
    buffers are allocated on the current stream before the side stream
    starts and are next used after it has been waited for.  The tensors'
    card is made the current one for the launches, so that all three go to
    its streams."""
    B, imax, W, tabs = _check("pairhmm_cuda.forward_backward_posterior",
                                codes1, len1, codes2, len2, tab)
    dev = codes1.device
    p = cuda_lib.ptr
    args = (p(codes1), p(len1), p(codes2), p(len2), *tabs)
    with torch.cuda.device(dev):
        planes = torch.empty((2, B, imax, W), dtype=torch.float32, device=dev)
        fcap = torch.empty((B, 6), dtype=torch.float32, device=dev)
        bcap = torch.empty((B, 3), dtype=torch.float32, device=dev)
        cur = torch.cuda.current_stream()
        index = torch.cuda.current_device()
        side = _SIDE_STREAMS.get(index)
        if side is None:
            side = _SIDE_STREAMS[index] = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            BACKWARD(*args, p(planes[1]), p(bcap), B, imax, W - 1)
        FORWARD(*args, p(planes[0]), p(fcap), B, imax, W - 1)
        cur.wait_stream(side)
        return _posterior(planes[0], fcap, planes[1], bcap, len1, len2, tab["init"])


def floor_probe(buf: torch.Tensor, steps: int, nwarps: int, B: int) -> None:
    """Launches the dependency-floor probe of csrc/pairhmm.cu: B blocks of
    `nwarps` warps walk `steps` diagonals, each the M chain of one cell
    after the design's hand-over.  For timing; it computes nothing of use.
    `buf`: at least B * 32 * nwarps float32 on the card."""
    cuda_lib.check(buf, "buf", torch.float32, buf.shape, buf.device)
    if buf.device.type != "cuda" or buf.numel() < B * 32 * nwarps:
        raise ValueError("pairhmm_cuda.floor_probe: buf too small or not on the card")
    FLOOR_PROBE(cuda_lib.ptr(buf), steps, nwarps, B)
