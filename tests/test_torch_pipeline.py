"""``repro_torch.data.pipeline`` against ``repro.data.pipeline``: the
batches' rows equal the reference's, index for index, for each ordering,
across epoch boundaries and on resume from a mid-epoch state; and
``synthetic.token_stream``'s unigram frequencies against the reference's
distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import EpochPipeline as JaxPipeline, PipelineState as JaxState
from repro_torch.data import synthetic
from repro_torch.data.pipeline import EpochPipeline, PipelineState

N, BATCH = 24, 4  # 6 batches an epoch


def _rows(pipe, state, n):
    out = []
    it = pipe.batches(state)
    for _ in range(n):
        batch, state = next(it)
        out.append((np.asarray(batch["ids"]).tolist(), np.asarray(batch["x"]).tolist(), state))
    return out


@pytest.mark.parametrize("start", [(0, 0), (0, 3), (1, 5)])
@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
def test_batches_equal_the_reference_index_for_index(ordering, start):
    ids = np.arange(N, dtype=np.int32)
    x = np.random.default_rng(0).normal(size=(N, 3)).astype(np.float32)
    port = EpochPipeline({"ids": torch.from_numpy(ids), "x": torch.from_numpy(x)}, BATCH, ordering=ordering)
    ref = JaxPipeline({"ids": jnp.asarray(ids), "x": jnp.asarray(x)}, BATCH, ordering=ordering)
    epoch, cursor = start
    got = _rows(port, PipelineState(epoch, cursor, seed=7), 14)  # crosses two epoch boundaries
    want = _rows(ref, JaxState(epoch, cursor, seed=7), 14)
    for (gi, gx, gs), (wi, wx, ws) in zip(got, want):
        assert gi == wi and gx == wx and gs.to_meta() == ws.to_meta()
    assert port.batches_per_epoch == ref.batches_per_epoch == N // BATCH


def test_resume_from_a_mid_epoch_state_replays_the_rest():
    data = {"ids": torch.arange(N)}
    pipe = EpochPipeline(data, BATCH, ordering="shuffle_always")
    it = pipe.batches(PipelineState(seed=3))
    full = [next(it) for _ in range(9)]
    resumed = pipe.batches(PipelineState.from_meta(full[3][1].to_meta()))
    for batch, state in full[4:]:
        b, s = next(resumed)
        assert torch.equal(b["ids"], batch["ids"]) and s == state


def test_pipeline_refuses_a_batch_that_does_not_divide_the_rows():
    with pytest.raises(ValueError, match="not divisible"):
        EpochPipeline({"ids": torch.arange(10)}, 4)


def test_token_stream_draws_the_reference_unigram():
    vocab = 64
    toks = synthetic.token_stream(torch.Generator().manual_seed(0), 256, 128, vocab)["tokens"]
    assert toks.shape == (256, 128) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    logits = -1.2 * np.log1p(np.arange(vocab, dtype=np.float64))
    want = np.exp(logits) / np.exp(logits).sum()
    got = np.bincount(toks.reshape(-1).numpy(), minlength=vocab) / toks.numel()
    # 32,768 draws: each frequency within 4 standard errors of its probability
    assert np.all(np.abs(got - want) <= 4 * np.sqrt(want * (1 - want) / toks.numel()) + 1e-12)
