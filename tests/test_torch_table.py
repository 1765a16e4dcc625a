"""repro_torch.engine.table (stored tables, the data-source axis) against
repro.engine.table, on the CPU.

The same numpy table goes into both packages as a ChunkedTable
(``convert.chunked_table_from_numpy`` and the reference's
``ChunkedTable.from_arrays``). Held: the Table protocol; the
fingerprint, computed chunk by chunk, equal to the materialized table's;
the eager chunk stream bit-identical to the resident fold; and the
port's stored-table runs equal to the reference's on its ChunkedTable
within the reference's engine tolerance (the kernel lanes run their
plain versions here, the reference its Pallas kernels in interpret
mode)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from _torch_obs import torch_obs_isolation  # noqa: F401  (autouse: the port's obs state, reset per test)
from repro import engine as ref_engine
from repro_torch import convert, engine
from repro_torch.engine import table as table_lib

torch.set_num_threads(1)

# the reference's engine-run tolerance (tests/test_implementation.py)
RTOL, ATOL = 1e-5, 1e-6
IMPLS = {"torch_fold": "xla_fold", "cuda_fused": "pallas_fused", "cuda_minibatch": "pallas_minibatch"}


def _table(n=80, d=4, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(x @ r.normal(size=d) + 0.3 * r.normal(size=n)).astype(np.float32)
    return {"x": x, "y": y}


def _query(data, task="logreg", **kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("tolerance", 0.0)
    return engine.AnalyticsQuery(task=task, data=data, task_args={"dim": 4}, **kw)


# -- the Table protocol ------------------------------------------------------


def test_chunked_table_protocol():
    arrays = _table(80)
    mem = convert.table_from_numpy(arrays, "cpu")
    tab = convert.chunked_table_from_numpy(arrays, 32, "cpu")
    assert table_lib.is_stored_table(tab) and not table_lib.is_stored_table(mem)
    assert tab.n_rows == 80 and tab.chunk_rows == 32 and tab.num_chunks == 3
    assert tab.chunk_shapes() == (16, 32)  # a ragged tail is one more shape
    assert [c["x"].shape[0] for c in tab.chunks()] == [32, 32, 16]
    assert tab.signature() == table_lib.signature_of(mem) == _query(mem).data_signature()
    assert tab.data_bytes() == _query(mem).data_bytes == 80 * 5 * 4
    slab = tab.probe_slab(40)  # across a chunk boundary
    assert all(torch.equal(slab[k], mem[k][:40]) for k in mem)
    assert tab.probe_slab(1000)["x"].shape[0] == 80
    assert tab._arrays is None
    full = table_lib.resolve(tab)
    assert full is tab.arrays() and all(torch.equal(full[k], mem[k]) for k in mem)
    assert table_lib.resolve(mem) is mem
    q = _query(tab)
    assert q.n_examples == 80 and q.cache_key_fields() == _query(mem).cache_key_fields()
    with pytest.raises(ValueError, match="chunk_rows"):
        engine.ChunkedTable.from_arrays(mem, 0)
    with pytest.raises(ValueError, match="at least one chunk"):
        engine.ChunkedTable([])


@pytest.mark.parametrize("n,chunk", [(80, 32), (96, 7), (5, 32), (128, 1)])
def test_fingerprint_chunk_by_chunk_equals_the_materialized_tables(n, chunk):
    arrays = _table(n)
    mem = convert.table_from_numpy(arrays, "cpu")
    tab = convert.chunked_table_from_numpy(arrays, chunk, "cpu")
    for rows in (6, 24, 200):
        want = table_lib.fingerprint_arrays(table_lib.signature_of(mem), mem, rows)
        assert tab.content_fingerprint(rows) == want == _query(mem).content_fingerprint(rows)
    assert tab._arrays is None  # fingerprinting must not materialize the table


def test_fingerprint_catches_an_interior_reorder():
    """Same rows, same boundary rows, interior reordered (label-clustered
    vs shuffled is exactly what the planner keys on): another print."""
    arrays = _table(128)
    perm = np.concatenate([np.arange(4), np.random.default_rng(0).permutation(np.arange(4, 124)),
                           np.arange(124, 128)])
    moved = {k: v[perm] for k, v in arrays.items()}
    for wrap in (lambda a: convert.table_from_numpy(a, "cpu"),
                 lambda a: convert.chunked_table_from_numpy(a, 32, "cpu")):
        assert _query(wrap(arrays)).content_fingerprint() != _query(wrap(moved)).content_fingerprint()


# -- the chunk stream ---------------------------------------------------------


@pytest.mark.parametrize("chunk", [32, 80, 7])
def test_eager_chunk_stream_is_bit_identical_to_the_resident_fold(chunk):
    arrays = _table(80)
    eng = engine.Engine(device="cpu")
    tab = convert.chunked_table_from_numpy(arrays, chunk, "cpu")
    res = eng.run(_query(tab, hints={"source": "table", "implementation": "torch_fold"}))
    assert res.plan.source == "table" and res.plan.ordering == "clustered"
    ref = eng.run(_query(convert.table_from_numpy(arrays, "cpu")),
                  plan=dataclasses.replace(res.plan, source="memory"))
    assert torch.equal(res.model, ref.model) and res.losses == ref.losses
    assert eng.stats["bytes_to_device"] == 0  # the chunks already lie on the engine's device


def test_planner_streams_only_the_clustered_serial_plan():
    arrays = _table(96)
    tab = convert.chunked_table_from_numpy(arrays, 32, "cpu")
    eng = engine.Engine(device="cpu")
    rep = eng.explain(_query(tab))
    for c in rep.candidates:
        streams = c.plan.ordering == "clustered" and c.plan.scheme == "serial"
        assert (c.plan.source == "table") == streams, c.plan
    assert "source=" in rep.describe()
    # (scheme pinned: which scheme wins is the probes' call, not this test's)
    assert eng.explain(_query(tab, hints={"ordering": "sequential", "scheme": "serial"})).chosen.source == "table"
    # a plan that materializes pays the source term; a streaming one does not
    mem_plan = next(c for c in rep.candidates if c.plan.source == "memory" and c.plan.scheme == "serial")
    comps, _ = engine.planner.cost_components(mem_plan.plan, _query(tab), rep.calibration, 2.0)
    assert comps["source"] > 0
    with pytest.raises(ValueError, match="stored Table"):
        eng.explain(_query(convert.table_from_numpy(arrays, "cpu"), hints={"source": "table"}))
    with pytest.raises(ValueError, match="streaming plan"):
        eng.explain(_query(tab, hints={"source": "table", "ordering": "shuffle_always"}))
    forced = eng.explain(_query(tab, hints={"source": "memory", "ordering": "clustered", "scheme": "serial"}))
    assert forced.chosen.source == "memory"


def test_shuffle_plan_over_a_stored_table_materializes_and_matches():
    arrays = _table(96)
    eng = engine.Engine(device="cpu")
    hints = {"ordering": "shuffle_once", "scheme": "serial", "implementation": "torch_fold"}
    r1 = eng.run(_query(convert.chunked_table_from_numpy(arrays, 32, "cpu"), hints=hints))
    r2 = eng.run(_query(convert.table_from_numpy(arrays, "cpu"), hints=hints))
    assert r1.plan.source == "memory" and torch.equal(r1.model, r2.model)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("task", ["logreg", "least_squares"])
def test_stored_table_run_matches_the_reference_on_its_chunked_table(task, impl):
    """source='table' end to end in both packages on the same 80-row
    table in 32-row chunks (a ragged tail): the port's chunk stream
    against the reference's, implementation by implementation."""
    arrays = _table(80)
    ref_tab = ref_engine.ChunkedTable.from_arrays({k: jax.numpy.asarray(v) for k, v in arrays.items()}, 32)
    tab = convert.chunked_table_from_numpy(arrays, 32, "cpu")
    ref_res = ref_engine.Engine().run(ref_engine.AnalyticsQuery(
        task=task, data=ref_tab, task_args={"dim": 4}, epochs=3, tolerance=0.0,
        hints={"source": "table", "implementation": IMPLS[impl]}))
    res = engine.Engine(device="cpu", draws=ThreefryReplay()).run(
        _query(tab, task, epochs=3, hints={"source": "table", "implementation": impl}))
    assert res.plan.source == ref_res.plan.source == "table"
    assert res.plan.implementation == impl and res.epochs == ref_res.epochs == 3
    np.testing.assert_allclose(res.model.numpy(), np.asarray(ref_res.model), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.losses, ref_res.losses, rtol=RTOL, atol=ATOL)


def test_host_chunks_move_to_the_engines_device_counted():
    """The engine's device differs from the chunks': each chunk is moved
    as the fold takes it and its bytes are counted (the meta device
    stands in for the card: moving to it needs no card)."""
    from repro_torch.engine import executor

    tab = convert.chunked_table_from_numpy(_table(80), 32, "cpu")
    stats = {"bytes_to_device": 0}
    moved = list(executor.stream_chunks(tab, torch.device("meta"), stats))
    assert [c["x"].device.type for c in moved] == ["meta"] * 3
    assert stats["bytes_to_device"] == tab.data_bytes()
    full = executor.materialize(tab, torch.device("meta"), stats)
    assert full["x"].shape == (80, 4) and stats["bytes_to_device"] == 2 * tab.data_bytes()
