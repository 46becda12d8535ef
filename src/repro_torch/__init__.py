"""PyTorch/CUDA port of the LPU serving stack (see src/repro for the JAX reference)."""
