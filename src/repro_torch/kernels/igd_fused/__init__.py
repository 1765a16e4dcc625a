"""The fused IGD transition: CUDA kernels (kernel.py, csrc/), plain versions
(ref.py) and the dispatch between them (ops.py). ``supports`` says which D
each kernel takes; importing it builds and loads nothing."""

from repro_torch.kernels.igd_fused.kernel import supports  # noqa: F401
