"""Optimizers (``repro.optim``): IGD/SGD, the paper's algorithm, and
AdamW, plus gradient compression."""

from repro_torch.optim import compression  # noqa: F401
from repro_torch.optim.sgd import IGD, AdamW  # noqa: F401
