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

Across devices the LM runs on ``torch.distributed.tensor`` (DTensor) over
a ``DeviceMesh``, one process a device (``dist.sharding``,
``launch.mesh``): gloo on the CPU, NCCL on the card.

Two modules of the reference are **not applicable** and have no port:

* ``engine/xla_cache.py`` (XLA's persistent compilation cache): the port
  compiles nothing but its hand-written kernels, and their build cache is
  ``kernels/_build.py`` (each source built once into the git-ignored
  ``build/`` directory, keyed by a hash of the source and the headers it
  includes);
* ``compat.py`` (shims over JAX's changing mesh API): PyTorch's API needs
  no shim here.

Nor is the HLO-text parser of ``launch/hlo_analysis.py`` (``analyze``):
the port has no HLO, and its dry run (``launch.dryrun``) counts the ops a
step executes with a dispatch mode (``launch.hlo_analysis.StepCounter``).
"""
