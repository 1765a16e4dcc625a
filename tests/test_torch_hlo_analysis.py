"""The port's roofline half of ``hlo_analysis`` against the reference's:
``roofline_terms`` / ``dominant`` (the reference's test at the H100's
figures), ``count_params`` and ``model_flops`` for all ten configs and
every applicable shape, ``engine.sweep.roofline_summary``'s line; and the
step counter that replaces ``analyze`` on hand-made steps: a matmul's
FLOPs and its operand bytes, and collectives by kind over a fake group."""

import re

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.engine import sweep as jsweep
from repro.launch import hlo_analysis as JH
from repro.models import lm as jlm
from repro_torch.configs import SHAPES, all_archs, get_arch, shape_applicable
from repro_torch.engine import sweep
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import lm

ARCHS = sorted(all_archs())


def test_roofline_terms_and_dominant():
    t = H.roofline_terms(989e12, 3.35e12, 900e9)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 1.0) < 1e-9
    assert abs(t["collective_s"] - 2.0) < 1e-9
    assert H.dominant(t) == "collective"
    t = H.roofline_terms(2 * 989e12, 3.35e12, 900e9, n_links=4)
    assert abs(t["collective_s"] - 0.5) < 1e-9
    assert H.dominant(t) == "compute"


def test_the_roofline_figures_are_the_h100s():
    assert (H.PEAK_FLOPS, H.HBM_BW, H.LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.fixture(scope="module")
def counts():
    out = {}
    for name in ARCHS:
        jabs = jax.eval_shape(lambda c=jconfigs.get_arch(name): jlm.init_lm(c, jax.random.PRNGKey(0)))
        want = JH.count_params(jabs, jconfigs.get_arch(name))
        got = H.count_params(lm.init_lm(get_arch(name), torch.Generator(), "meta"), get_arch(name))
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_count_params_equals_the_reference(counts, name):
    (total, active), (jtotal, jactive) = counts[name]
    assert total == jtotal
    assert active == jactive
    if get_arch(name).n_experts:
        assert active < total


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_equal_the_reference(counts, name):
    (total, active), _ = counts[name]
    applicable = [s for s in SHAPES if shape_applicable(get_arch(name), SHAPES[s])]
    assert applicable
    for s in applicable:
        jshape = jconfigs.SHAPES[s]
        assert jconfigs.shape_applicable(jconfigs.get_arch(name), jshape)
        want = JH.model_flops(jconfigs.get_arch(name), jshape, total, int(active))
        assert H.model_flops(get_arch(name), SHAPES[s], total, int(active)) == want


def test_roofline_summary_has_the_references_form():
    # the same seconds at each one's figures give the same line
    secs = {"coll": 3.14, "mem": 0.52, "comp": 12.3}
    temp = 7.5 * 2**30
    ref = {"collective_traffic_bytes": secs["coll"] * 50e9, "hlo_hbm_bytes": secs["mem"] * 819e9,
           "hlo_flops": secs["comp"] * 197e12, "temp_bytes": temp}
    port = {"collective_traffic_bytes": secs["coll"] * 450e9, "hlo_hbm_bytes": secs["mem"] * 3.35e12,
            "hlo_flops": secs["comp"] * 989e12, "temp_bytes": temp}
    line = sweep.roofline_summary(port)
    assert line == jsweep.roofline_summary(ref)
    assert re.fullmatch(r"coll [\d.]+ mem [\d.]+ comp [\d.]+ temp_gb [\d.]+", line)
    proj = {k + "_proj": v for k, v in port.items() if k != "temp_bytes" and k != "hlo_flops"}
    assert sweep.roofline_summary(dict(proj, hlo_flops=port["hlo_flops"], temp_bytes=temp), projected=True) == line
    assert sweep.roofline_summary({}) == jsweep.roofline_summary({})


def test_counter_prices_a_matmul_and_its_operand_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    fm = FakeTensorMode()
    with fm:
        a, b = torch.empty((64, 32)), torch.empty((32, 16), dtype=torch.float32)
    counter = H.StepCounter(fm)
    counter.hold((a, b))
    with counter:
        c = (a @ b).relu()
        d = torch.bmm(c[None], b.T[None].contiguous())
    st = counter.analysis()
    assert st.flops == 2 * 64 * 32 * 16 + 2 * 64 * 16 * 32
    assert st.dot_count == 2
    assert st.hbm_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) + 4 * (64 * 16 + 16 * 32 + 64 * 32)
    assert st.collectives_by_kind == {} and st.collective_traffic_bytes == 0
    # live at the peak: the relu's output (the matmul's is freed by then),
    # the transposed copy and the bmm's output
    assert st.temp_bytes == 4 * (64 * 16 + 16 * 32 + 64 * 32)
    del c, d


def test_counter_counts_collectives_by_kind_on_local_shards():
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_lib

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with mesh_lib.fake_mesh({"data": 2, "model": 4}) as mesh, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x = shd.fake_with_sharding({"x": torch.empty((8, 64), device="meta")}, {"x": shd.P("data", "model")},
                                   mesh, fm)["x"]
        w = shd.fake_with_sharding({"w": torch.empty((64, 16), device="meta")}, {"w": shd.P("model", None)},
                                   mesh, fm)["w"]
        counter = H.StepCounter(fm)
        with counter:
            y = (x @ w).full_tensor()  # a contraction over "model" (partial sums), then gathered
        st = counter.analysis()
        assert tuple(y.shape) == (8, 16)
    # each rank multiplies its [4, 16] by its [16, 16]: the DTensor op at its local shapes
    assert st.flops == 2 * 4 * 16 * 16
    kinds = st.collectives_by_kind
    assert set(kinds) <= {"all-gather", "all-reduce", "reduce-scatter"} and kinds
    assert st.collective_operand_bytes == sum(v["bytes"] for v in kinds.values())
    assert st.collective_traffic_bytes == st.collective_operand_bytes + kinds.get("all-reduce", {}).get("bytes", 0)
    assert st.hbm_bytes == 4 * (4 * 16 + 16 * 16 + 4 * 16) + 2 * st.collective_operand_bytes
