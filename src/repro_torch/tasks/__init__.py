"""Analytics tasks: the dense GLMs of paper Fig. 4."""

from repro_torch.tasks.base import Task  # noqa: F401
from repro_torch.tasks.glm import SVM, LeastSquares, LogisticRegression  # noqa: F401
