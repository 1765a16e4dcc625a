"""Flash decode, one query token against a KV cache: a hand-written CUDA
kernel (``kernel``), its plain PyTorch version (``ref``) and the dispatch
(``ops``)."""
