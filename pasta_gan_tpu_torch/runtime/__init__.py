"""Training configuration."""
