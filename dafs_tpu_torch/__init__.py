"""DAFS in PyTorch: simultaneous aligning and folding of RNA sequences on an
NVIDIA GPU.

The port of the JAX package `dafs_tpu`, which stays beside it as the
reference.  Host orchestration (guide tree, projections, output) is numpy;
the numerics run as PyTorch tensors on an explicit `device`; the four
dynamic programs that the JAX package wrote as Pallas TPU kernels are CUDA
C++ kernels for Hopper (`csrc/`, built with nvcc at first use and bound with
ctypes).  On CPU tensors every kernel wrapper runs its plain PyTorch version.

This package imports neither JAX nor `dafs_tpu`.
"""

__version__ = "0.1.0"

import torch as _torch

# Everything is float32 and the reference contracts its tables at exact
# f32 (`dafs_tpu/__init__.py`); TF32 keeps about three decimal digits, below
# the level at which decoded alignments move.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from dafs_tpu_torch.fasta import Fasta, load_fasta  # noqa: E402,F401
from dafs_tpu_torch.api import Result, align_and_fold  # noqa: E402,F401
