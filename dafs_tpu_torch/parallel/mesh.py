"""Sharding of the all-pairs workloads over a mesh of devices.

Port of `dafs_tpu/parallel/mesh.py` in PyTorch's idiom: the work mesh is a
list of `torch.device`s, one per shard, not a named mesh.  The
N(N-1)/2 pair-HMM problems, the N folding problems and the two PCT
worklists split data-parallel over it: the gates in
`models/align_models.ProbCons`, `models/fold_models.RNAfold` and
`consistency` take the sharded path when the mesh has more than one shard.
Every shard runs the same kernels on its rows at the global batch's padded
shapes; all shards are launched before any result is read back, so the
cards work at once, and the host gathers the results in batch order.
Nothing else shards: the merges, the consensus and the final decode run on
the mesh's first device, as in `dafs_tpu`.

A batch of n rows is laid over s shards as `dafs_tpu` lays it over its
mesh: padded to a multiple of s, shard k holding rows [k*per, (k+1)*per)
(`shard_slices`).  Padding rows are trivial problems whose results are
dropped.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_FORCE_SINGLE = False
_SHARDS: int | None = None


@contextlib.contextmanager
def force_single_device():
    """Run as if one device were attached: every gate sees one shard.
    `dryrun.dryrun_multichip` runs each configuration under it to show
    that the sharded run is byte-equal to the single-device run."""
    global _FORCE_SINGLE
    prev = _FORCE_SINGLE
    _FORCE_SINGLE = True
    try:
        yield
    finally:
        _FORCE_SINGLE = prev


@contextlib.contextmanager
def virtual_mesh(n: int):
    """A work mesh of `n` shards: the first n of the devices a request
    names, or, where it names fewer, n shards on its first device (on one
    card, or on the CPU).  The port's counterpart of an XLA host platform
    with n devices; a test seam, not a user option."""
    global _SHARDS
    if n < 1:
        raise ValueError(f"virtual_mesh: {n} shards")
    prev = _SHARDS
    _SHARDS = n
    try:
        yield
    finally:
        _SHARDS = prev


def work_devices(device) -> list[torch.device]:
    """The work mesh of a device request, one entry per shard.

    "cuda" with no index is every visible card, cuda:0 to cuda:n-1
    (`CUDA_VISIBLE_DEVICES` selects them); "cuda:k" is that card alone;
    "cpu" the CPU.  One entry under `force_single_device`; `virtual_mesh`
    sets the count."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        devs = [torch.device("cuda", k) for k in range(count)]
    else:
        devs = [dev]
    if _FORCE_SINGLE:
        return devs[:1]
    if _SHARDS is not None:
        return devs[:_SHARDS] if len(devs) >= _SHARDS else [devs[0]] * _SHARDS
    return devs


def work_device_count(device) -> int:
    """Shards of the work mesh of `device` (1 under force_single_device)."""
    return len(work_devices(device))


def shard_slices(n: int, shards: int) -> tuple[int, list[slice]]:
    """(padded row count, each shard's slice of the padded rows)."""
    per = -(-n // shards)
    return per * shards, [slice(k * per, (k + 1) * per) for k in range(shards)]


def pad_rows(a: np.ndarray, rows: int, fill) -> np.ndarray:
    """`a` with rows appended up to `rows`, each filled with `fill`."""
    out = np.full((rows,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


def gather(outs: list[torch.Tensor], n: int) -> np.ndarray:
    """The shards' outputs as one host array in batch order, padding rows
    dropped; reads each back after all were launched."""
    return np.concatenate([o.cpu().numpy() for o in outs])[:n]


def sharded_pair_posteriors(seqs1, seqs2, threshold, devices):
    """All given sequence pairs, sharded over `devices`: the batch padded
    to a multiple of the shard count with length-1 pairs, every row at the
    whole batch's padded lengths, K1, K2 and the posterior kernel on each
    shard's device (`ops/pairhmm.batch_posteriors`)."""
    from dafs_tpu_torch.ops import pairhmm  # which imports this module

    return pairhmm.batch_posteriors(seqs1, seqs2, threshold, devices[0], devices=devices)


def sharded_bp_posteriors(seqs, threshold, devices, bl=True, constraints=None):
    """Per-sequence McCaskill BP posteriors sharded over `devices`: each
    length bucket padded to a multiple of the shard count with length-1
    rows, one pf-scale ladder over the whole bucket, every shard launched
    in each attempt (`ops/mccaskill.batch_bp_posteriors_fast`)."""
    from dafs_tpu_torch.ops import mccaskill  # which imports this module

    return mccaskill.batch_bp_posteriors_fast(
        seqs, threshold, devices[0], bl=bl, constraints=constraints, devices=devices)
