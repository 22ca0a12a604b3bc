"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the contract the core engine calls; it dispatches on the
tensor's device (a CUDA tensor launches a CUDA kernel from ``csrc/``, a
CPU tensor runs the plain PyTorch version in ``ref``).
"""
