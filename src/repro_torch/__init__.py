"""PyTorch/CUDA port of the P/D-Serve reproduction (see src/repro for
the JAX reference)."""
