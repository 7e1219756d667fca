"""PyTorch port of the ADSALA stack for one NVIDIA H100.

Mirrors :mod:`repro` path for path.  ``core/`` is the jax-free tuning
stack carried over unchanged; ``kernels/`` holds the hand-written
Hopper kernels beside their plain PyTorch versions; ``models/``,
``configs/``, ``train/`` and ``launch/`` carry the dense LM serving
path.  Imports torch and numpy only: never jax, never
:mod:`repro`.
"""
