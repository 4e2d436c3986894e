"""Per-material depth evaluation and 2-D analysis of predictions."""
