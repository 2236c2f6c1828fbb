"""PyTorch/CUDA port of DeepConsensus-TPU for NVIDIA Hopper GPUs.

A package of its own beside deepconsensus_tpu (the JAX reference): it
imports torch and numpy, never jax or the reference package.
"""
