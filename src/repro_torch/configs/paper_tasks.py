"""Paper-task configurations: dataset sizes mirroring Table 1 (scaled
down) and the hyperparameters the benchmarks use — the port's own copy
of the reference's rows (``repro.configs.paper_tasks``)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str
    task: str  # lr | svm | lmf | crf | kalman | portfolio
    n_examples: int
    dim: int = 0
    nnz: int = 0  # sparse tasks
    n_rows: int = 0
    n_cols: int = 0
    rank: int = 0
    seq_len: int = 0
    n_labels: int = 0
    alpha0: float = 0.5
    mu: float = 0.0


# Scaled-down stand-ins for Table 1 datasets (the scalability benchmark
# scales n_examples up).
FOREST = TaskConfig("forest", "lr", n_examples=8192, dim=54, alpha0=0.5)
FOREST_SVM = TaskConfig("forest-svm", "svm", n_examples=8192, dim=54, alpha0=0.1)
DBLIFE = TaskConfig("dblife", "lr", n_examples=4096, dim=8192, nnz=16, alpha0=0.5)
DBLIFE_SVM = TaskConfig("dblife-svm", "svm", n_examples=4096, dim=8192, nnz=16, alpha0=0.1)
MOVIELENS = TaskConfig(
    "movielens", "lmf", n_examples=65536, n_rows=1024, n_cols=512, rank=8,
    alpha0=0.05, mu=1e-2,
)
CONLL = TaskConfig(
    "conll", "crf", n_examples=256, seq_len=32, dim=64, n_labels=9, alpha0=0.2
)
KALMAN = TaskConfig("kalman", "kalman", n_examples=2048, dim=16, alpha0=0.02)
PORTFOLIO = TaskConfig("portfolio", "portfolio", n_examples=4096, dim=64, alpha0=0.02)

ALL = {c.name: c for c in (
    FOREST, FOREST_SVM, DBLIFE, DBLIFE_SVM, MOVIELENS, CONLL, KALMAN, PORTFOLIO
)}
