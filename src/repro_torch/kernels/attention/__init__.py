"""Causal GQA flash attention: a hand-written CUDA kernel (``kernel``),
its plain PyTorch version (``ref``) and the dispatch (``ops``)."""
