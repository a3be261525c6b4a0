"""Synthetic datasets with the paper's skew."""
