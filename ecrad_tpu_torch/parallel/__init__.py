"""Column blocking of the offline driver (one GPU)."""
