"""Synthetic dataset generators matching the paper's workload shapes.

| paper dataset | generator             | shape                          |
|---------------|-----------------------|--------------------------------|
| Forest        | dense_classification  | dense features, binary labels  |
| DBLife        | sparse_classification | padded (idx, val) sparse rows  |
| MovieLens     | ratings               | (i, j, v) triples              |
| CoNLL         | tagged_sequences      | (x, y, mask) sentences         |
| (Fig. 1B)     | kalman_series         | (t, y) observations            |
| (Fig. 1B)     | returns               | centered return vectors        |
| (LM training) | token_stream          | Zipf-ish unigram token ids     |

The data is made on ``generator.device`` from the generator's stream, so
a full-size table never passes through the host. The classification
tables come *clustered by label* by default (positives first), the
ratings sorted by row — the RDBMS heap-order pathology the paper
studies; apply an ordering policy to randomize. The streams are torch's,
not the JAX package's: the same seed makes other rows of the same
shapes and distributions (``token_stream``: the same unigram)."""

from __future__ import annotations

import math

import torch


def dense_classification(
    generator: torch.Generator, n: int, dim: int, *, margin: float = 1.0,
    noise: float = 0.5, clustered: bool = True,
):
    """Linearly-separable-ish binary data; labels ±1. Clustered: +1 first."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_true = torch.randn((dim,), generator=generator, **f32) / math.sqrt(dim)
    half = n // 2
    y = torch.cat([torch.ones(half, **f32), -torch.ones(n - half, **f32)])
    x = torch.randn((n, dim), generator=generator, **f32) / math.sqrt(dim)
    # push each point to its label's side of the separator
    proj = x @ w_true
    x += ((margin * y - proj) / torch.sum(w_true**2))[:, None] * w_true[None, :]
    x += noise * torch.randn((n, dim), generator=generator, **f32) / math.sqrt(dim)
    if not clustered:
        perm = torch.randperm(n, generator=generator, device=dev)
        x, y = x[perm], y[perm]
    return {"x": x, "y": y}


def sparse_classification(generator: torch.Generator, n: int, dim: int, nnz: int, *,
                          clustered: bool = True):
    """DBLife-like sparse rows: ``nnz`` active features per example, padded
    format (idx int32, val float32); idx == -1 is padding."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_true = torch.randn((dim,), generator=generator, **f32)
    half = n // 2
    y = torch.cat([torch.ones(half, **f32), -torch.ones(n - half, **f32)])
    idx = torch.randint(0, dim, (n, nnz), generator=generator, device=dev)
    val = torch.abs(torch.randn((n, nnz), generator=generator, **f32))
    # correlate values with the label through w_true[idx]
    val = val * torch.sign(w_true)[idx] * y[:, None]
    val = val + 0.3 * torch.randn((n, nnz), generator=generator, **f32)
    if not clustered:
        perm = torch.randperm(n, generator=generator, device=dev)
        idx, val, y = idx[perm], val[perm], y[perm]
    return {"idx": idx.to(torch.int32), "val": val, "y": y}


def ratings(generator: torch.Generator, n_rows: int, n_cols: int, n_ratings: int, rank: int = 4):
    """MovieLens-like (i, j, v) triples from a planted low-rank matrix.
    Clustered order: sorted by row index (a realistic storage order)."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    l_true = torch.randn((n_rows, rank), generator=generator, **f32) / math.sqrt(rank)
    r_true = torch.randn((n_cols, rank), generator=generator, **f32) / math.sqrt(rank)
    i = torch.randint(0, n_rows, (n_ratings,), generator=generator, device=dev)
    j = torch.randint(0, n_cols, (n_ratings,), generator=generator, device=dev)
    v = torch.sum(l_true[i] * r_true[j], dim=-1)
    v = v + 0.05 * torch.randn((n_ratings,), generator=generator, **f32)
    order = torch.argsort(i, stable=True)  # clustered by row
    return {"i": i[order].to(torch.int32), "j": j[order].to(torch.int32), "v": v[order]}


def tagged_sequences(generator: torch.Generator, n: int, seq_len: int, n_labels: int, feat_dim: int):
    """CoNLL-like sentences: per-token features correlated with a planted
    emission matrix plus a Markov label chain (each step's label drawn
    from softmax(t_logits[previous label]))."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    e_true = torch.randn((n_labels, feat_dim), generator=generator, **f32)
    t_probs = torch.softmax(2.0 * torch.randn((n_labels, n_labels), generator=generator, **f32), dim=-1)
    y = torch.randint(0, n_labels, (n,), generator=generator, device=dev)
    ys = [y]
    for _ in range(seq_len - 1):
        y = torch.multinomial(t_probs[y], 1, generator=generator)[:, 0]
        ys.append(y)
    ys = torch.stack(ys, dim=1)
    x = e_true[ys] + 0.8 * torch.randn((n, seq_len, feat_dim), generator=generator, **f32)
    mask = torch.ones((n, seq_len), **f32)
    return {"x": x, "y": ys.to(torch.int32), "mask": mask}


def kalman_series(generator: torch.Generator, horizon: int, state_dim: int, obs_dim: int, c_seed: int = 0):
    """Noisy observations of a planted linear dynamical system, the one
    ``tasks.kalman.system_matrices(c_seed, ...)`` gives the task."""
    from repro_torch.tasks.kalman import system_matrices

    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    c, a = system_matrices(c_seed, state_dim, obs_dim, dev)
    w = torch.randn((state_dim,), generator=generator, **f32)
    noise = 0.1 * torch.randn((horizon, state_dim), generator=generator, **f32)
    ws = []
    for t in range(horizon):
        w = a @ w + noise[t]
        ws.append(w)
    ys = torch.stack(ws) @ c.T + 0.05 * torch.randn((horizon, obs_dim), generator=generator, **f32)
    return {"t": torch.arange(horizon, dtype=torch.int32, device=dev), "y": ys}


def returns(generator: torch.Generator, n_periods: int, n_assets: int):
    """Centered asset-return vectors with a planted factor covariance."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_factors = max(2, n_assets // 4)
    loadings = torch.randn((n_assets, n_factors), generator=generator, **f32) / math.sqrt(n_factors)
    factors = torch.randn((n_periods, n_factors), generator=generator, **f32)
    r = factors @ loadings.T + 0.1 * torch.randn((n_periods, n_assets), generator=generator, **f32)
    return {"r": r - torch.mean(r, dim=0, keepdim=True)}


def token_stream(generator: torch.Generator, n_docs: int, seq_len: int, vocab: int):
    """Synthetic token batches for the LM substrate: int32 [n_docs, seq_len]
    drawn i.i.d. from the reference's Zipf-ish unigram, softmax of
    -1.2 * log1p(arange(vocab)). Only the distribution is the reference's:
    the draws are torch's."""
    logits = -1.2 * torch.log1p(torch.arange(vocab, dtype=torch.float32, device=generator.device))
    toks = torch.multinomial(torch.softmax(logits, dim=0), n_docs * seq_len, replacement=True,
                             generator=generator)
    return {"tokens": toks.reshape(n_docs, seq_len).to(torch.int32)}
