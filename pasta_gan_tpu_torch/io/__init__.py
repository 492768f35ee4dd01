"""Weights in and out: snapshots and the JAX-variables translation."""
