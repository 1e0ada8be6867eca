"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); ``launches`` in each ops module
counts the kernel launches.
"""
