"""Distribution layer of the port: the shared-nothing data-parallel IGD
layouts and merges behind ``repro_torch.engine.shard``
(``data_parallel``). The reference's LM-side ``sharding`` and
``collectives`` come with the rest of the LM stack (ROADMAP queue 1
item 7)."""

from repro_torch.dist import data_parallel  # noqa: F401
