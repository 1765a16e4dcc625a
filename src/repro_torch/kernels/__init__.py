"""Hand-written Hopper kernels, each with a plain PyTorch version beside it."""
