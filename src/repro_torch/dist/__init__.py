"""Distribution layer of the port.

* ``data_parallel`` — the shared-nothing data-parallel IGD layouts and
  merges behind ``repro_torch.engine.shard`` (one process drives every
  device);
* ``sharding`` — the LM's partition specs (params, batches, caches,
  activations) and their DTensor placements on a ``DeviceMesh``, one
  process a device;
* ``collectives`` — the length-sharded flash decode and its logsumexp
  combine.
"""

from repro_torch.dist import data_parallel  # noqa: F401
