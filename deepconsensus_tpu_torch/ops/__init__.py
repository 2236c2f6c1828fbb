"""Hand-written CUDA kernels (K1-K3) and their plain versions."""
