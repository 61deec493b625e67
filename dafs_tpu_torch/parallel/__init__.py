"""Multi-device execution: the work mesh and its sharded stages (`mesh`),
several processes under `torch.distributed` (`multiproc`), and the
multichip dry run (`dryrun`)."""
