"""Host ILP decoders (IPknot), copied from `dafs_tpu.decoders_ip`."""
