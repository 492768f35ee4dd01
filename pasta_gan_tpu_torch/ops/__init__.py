"""Compute ops: plain PyTorch ops and the routing kernels and their wrappers."""
