"""Architecture registry of the port. Only llama3.2-3b (the dense family)
is registered: the other architectures come with the slices that port
their families (ROADMAP queue 1 item 12)."""

from repro_torch.configs import llama3_2_3b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    SHAPES,
    ShapeConfig,
    all_archs,
    get_arch,
)
