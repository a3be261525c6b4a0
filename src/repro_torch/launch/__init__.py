"""Launchers of the port: `serve` (dense LM prefill + decode, optional retrieval)."""
