"""Network building blocks (NCHW)."""
