"""Training steps of the port (single GPU)."""
