"""Data pipeline: deterministic synthetic streams + prefetch."""
