"""The port's CUDA kernels: build plumbing (``common``) and one wrapper
module per kernel, each with its plain PyTorch version beside it."""
