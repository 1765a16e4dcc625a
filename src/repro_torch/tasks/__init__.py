"""Analytics tasks: the techniques of paper Fig. 1B."""

from repro_torch.tasks.base import Task  # noqa: F401
from repro_torch.tasks.crf import LinearChainCRF  # noqa: F401
from repro_torch.tasks.glm import (  # noqa: F401
    SVM,
    LeastSquares,
    LogisticRegression,
    SparseLogisticRegression,
    SparseSVM,
)
from repro_torch.tasks.kalman import KalmanFilterTask  # noqa: F401
from repro_torch.tasks.lmf import LowRankMF  # noqa: F401
from repro_torch.tasks.portfolio import PortfolioOpt  # noqa: F401
