"""The plain reference the benchmark holds the port to.

Frozen copies of `dafs_tpu_torch`'s plain PyTorch and numpy versions of
what the cells' configurations run (the McCaskill fold, the ProbCons
pair-HMM, PCT and similarity, the guide tree, the RNAalifold consensus, the
projections, the Nussinov and NW decoders and the device DD loop), with
every CUDA kernel and mesh path taken out, so that on a card they run as
plain PyTorch on one device.  It imports nothing of the port, JAX or `dafs_tpu`; it reads
the parameter files by path as the port does (`dafs_tpu/ops/data/*.npz`).
`family.py` puts the pieces together; it finds each configuration's fold
and align model by name, one file a model under `fold/` and `align/`.
TF32 stays off unless the caller turns it on (the control run,
`portbench/control.py`).
"""
