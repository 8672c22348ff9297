"""Pipeline stages: plain PyTorch, and the wrappers of the CUDA kernels."""
