"""The fused IGD transition: CUDA kernels (kernel.py, csrc/), plain versions
(ref.py) and the dispatch between them (ops.py)."""
