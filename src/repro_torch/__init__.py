"""repro_torch — the data version-control engine in PyTorch, with its
kernels hand-written in CUDA for NVIDIA Hopper (sm_90a).

The port of ``repro`` (the JAX/Pallas reference package, which it never
imports). Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.
"""
