"""Launchers: serve (fixed-batch prefill + decode with the tuner)."""
