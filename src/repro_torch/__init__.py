"""repro_torch — the PyTorch/CUDA port of ``repro``.

The package mirrors ``repro``'s module names so each port sits beside
its counterpart's name: ``core`` (IGD primitives, the UDA fold,
orderings), ``tasks`` (the dense GLMs), ``data`` (synthetic tables),
``kernels`` (hand-written CUDA kernels for Hopper, each with a plain
PyTorch version beside it) and ``engine`` (catalog, planner, program
compiler and executor).

It imports ``torch`` and never ``jax`` or ``repro``; what it needs from
there it keeps its own copy of. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
