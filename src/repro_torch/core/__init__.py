"""Offline index build and host-side online planning (stages a, Alg. 1/2)."""
