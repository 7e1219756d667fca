"""Step builders (serving slice: the runtime context only)."""
