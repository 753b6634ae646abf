"""Host plan layer of the PyTorch port against the JAX package: graph,
sampler and plan compiler are numpy on both sides, so they must agree
EXACTLY on the same seed."""
import numpy as np
import pytest
import torch

from repro.core import PATTERN_NAMES
from repro.core import answer_query as j_answer
from repro.core import compile_batch as j_compile
from repro.data import load_dataset as j_load
from repro_torch.core import answer_query as t_answer
from repro_torch.core import compile_batch as t_compile
from repro_torch.data import load_dataset as t_load
from torch_parity import graphs, queries

torch.set_num_threads(1)


def test_kg_adjacency_matches():
    jkg, tkg = graphs()
    np.testing.assert_array_equal(jkg.triples, tkg.triples)
    np.testing.assert_array_equal(jkg.degree, tkg.degree)
    np.testing.assert_array_equal(jkg.entities_with_incoming,
                                  tkg.entities_with_incoming)
    for a, b in zip(jkg.incoming_by_tail, tkg.incoming_by_tail):
        np.testing.assert_array_equal(a, b)
    rows = np.random.default_rng(0).integers(0, 10, size=(64, 3))
    rows[:32] = jkg.triples[:32]
    np.testing.assert_array_equal(jkg.contains(rows), tkg.contains(rows))
    heads = np.arange(0, 200, 7)
    for r in range(jkg.n_relations):
        np.testing.assert_array_equal(jkg.neighbors_of_set(heads, r),
                                      tkg.neighbors_of_set(heads, r))


def test_load_dataset_reduced_matches():
    (jt, jf, js), (tt, tf, ts) = j_load("FB15k", seed=1), t_load("FB15k", seed=1)
    np.testing.assert_array_equal(jt.triples, tt.triples)
    np.testing.assert_array_equal(jf.triples, tf.triples)
    assert js.n_entities == ts.n_entities == 14_951


@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_sampler_same_queries(pattern):
    from repro.sampling import OnlineSampler as JSampler
    from repro_torch.sampling import OnlineSampler as TSampler

    jkg, tkg = graphs()
    js = JSampler(jkg, patterns=[pattern], seed=3).sample_batch(6)
    ts = TSampler(tkg, patterns=[pattern], seed=3).sample_batch(6)
    for a, b in zip(js, ts):
        assert a.query.pattern == b.query.pattern == pattern
        np.testing.assert_array_equal(a.query.anchors, b.query.anchors)
        np.testing.assert_array_equal(a.query.relations, b.query.relations)
        np.testing.assert_array_equal(a.answers, b.answers)
        assert j_answer(jkg, a.query) == t_answer(tkg, b.query)


def _assert_plans_equal(jp, tp):
    assert jp.signature == tp.signature
    assert jp.meta == tp.meta
    for field in ("slot_arrays", "bind_arrays"):
        ja, ta = getattr(jp, field), getattr(tp, field)
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(jp.answer_slots, tp.answer_slots)
    np.testing.assert_array_equal(jp.order, tp.order)
    assert jp.n_slots_padded == tp.n_slots_padded
    assert (jp.report.nodes_before, jp.report.nodes_after) == (
        tp.report.nodes_before, tp.report.nodes_after)


@pytest.mark.parametrize("cse", [True, False])
@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_compile_batch_exact(pattern, cse):
    jq, tq = queries(5, seed=4, patterns=[pattern])
    # Repeat two queries so CSE has whole trees and shared prefixes to merge.
    jq, tq = jq + jq[:2], tq + tq[:2]
    jp = j_compile(jq, model_name="betae", b_max=4, cse=cse)
    tp = t_compile(tq, model_name="betae", b_max=4, cse=cse)
    _assert_plans_equal(jp, tp)


@pytest.mark.parametrize("b_max", [4, 256])
@pytest.mark.parametrize("cse", [True, False])
def test_compile_mixed_batch_exact(cse, b_max):
    jq, tq = queries(40, seed=5)
    jp = j_compile(jq, model_name="gqe", b_max=b_max, cse=cse)
    tp = t_compile(tq, model_name="gqe", b_max=b_max, cse=cse)
    _assert_plans_equal(jp, tp)


def test_device_args_carry_the_plan():
    _, tq = queries(12, seed=6)
    plan = t_compile(tq, model_name="gqe", b_max=8)
    steps, ans = plan.device_args(torch.device("cpu"))
    np.testing.assert_array_equal(ans.numpy(), plan.answer_slots)
    for st, s, b in zip(steps, plan.slot_arrays, plan.bind_arrays):
        for k, a in {**s, **b}.items():
            assert st[k].dtype == torch.int64
            np.testing.assert_array_equal(st[k].numpy(), a)
