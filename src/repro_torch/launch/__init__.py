"""Launchers of the port: `serve` (LM prefill + decode, optional retrieval),
`train` (the fault-tolerant Trainer), `dryrun` / `dryrun_matrix` (every
cell's FLOPs, bytes and memory on the meta device), `roofline_report` (the
dry run's tables at a device's peaks) and `env` (the CUDA environment)."""
