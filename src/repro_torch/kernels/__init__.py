"""Hopper kernels of the query path, their plain versions and wrappers."""
