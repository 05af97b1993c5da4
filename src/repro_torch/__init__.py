"""repro_torch — the PyTorch and CUDA port of the AMPED reproduction.

A package beside the JAX reference (``repro``) that runs CP-ALS with the
MTTKRP hot loop (the EC) in CUDA kernels written by hand for NVIDIA Hopper.
It imports ``torch`` and numpy, never ``jax``, and nothing of ``repro``: the
numpy planner it needs is copied here and held bitwise against the
reference by the tests. Entry points run on the card unless the caller asks
for the CPU, where every kernel runs its plain PyTorch version.
"""
