"""The benchmark's frozen copies against today's port: the same graph, the
same queries, and kernel counts that read each input byte once."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, traffic
from perfbench.graph import generate_synthetic_kg
from perfbench.sampler import TEMPLATES, OnlineSampler


@pytest.mark.parametrize("shape", [(600, 40, 8000, 0), (2000, 60, 9000, 3)])
def test_graph_is_the_ports(shape):
    from repro_torch.data.kg import generate_synthetic_kg as port_kg
    n_e, n_r, n_t, seed = shape
    ours = generate_synthetic_kg(n_e, n_r, n_t, seed=seed)
    theirs = port_kg(n_e, n_r, n_t, seed=seed)
    np.testing.assert_array_equal(ours.triples, theirs.triples)
    np.testing.assert_array_equal(ours.degree, theirs.degree)


@pytest.mark.parametrize("patterns", [None, ("1p", "2p", "3p")])
@pytest.mark.parametrize("seed", [11, 2**31 + 9])
def test_queries_are_make_workloads(patterns, seed):
    from repro_torch.data.kg import generate_synthetic_kg as port_kg
    from repro_torch.serving.loadgen import make_workload
    graph = generate_synthetic_kg(600, 40, 8000, seed=0)
    want = make_workload(port_kg(600, 40, 8000, seed=0), 300, seed=seed, patterns=patterns)
    got = OnlineSampler(graph, patterns=patterns or tuple(TEMPLATES), seed=seed).sample_batch(300)
    assert [(q.pattern, tuple(q.anchors.tolist()), tuple(q.relations.tolist()))
            for q in want] == [tuple(q) for q in got]


def test_pool_holds_each_patterns_share_of_distinct_queries():
    graph = generate_synthetic_kg(600, 40, 8000, seed=0)
    mix = {"patterns": {p: 1 for p in TEMPLATES}, "pool": 280, "clients": 8}
    for seed in (5, 6):
        pool = traffic.make_pool(graph, mix, seed)
        assert len(set(pool)) == 280
        assert {p: sum(q.pattern == p for q in pool) for p in TEMPLATES} == \
            {p: 20 for p in TEMPLATES}
    assert traffic.make_pool(graph, mix, 5) != traffic.make_pool(graph, mix, 6)
    assert traffic.pattern_counts({"a": 1, "b": 1, "c": 1}, 8192) == \
        {"a": 2731, "b": 2731, "c": 2730}


def test_feed_never_sends_a_query_in_flight():
    feed = traffic.Feed(20, seed=3)
    inflight = [feed.next() for _ in range(12)]
    rng = np.random.default_rng(0)
    for _ in range(2000):
        assert len(set(inflight)) == len(inflight)
        j = int(rng.integers(len(inflight)))
        feed.landed(inflight.pop(j))
        inflight.append(feed.next())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("n,k,d,hd", [(8, 2, 800, 800), (3, 3, 32, 24)])
def test_intersect_count_reads_each_input_byte_once(n, k, d, hd):
    from repro_torch.kernels.intersect import intersect_ref
    x, w1, b1 = torch.randn(n, k, d), torch.randn(d, hd), torch.randn(hd)
    w2, b2 = torch.randn(hd, 1), torch.randn(1)
    with FlopCounterMode(display=False) as fc:
        out = intersect_ref(x, w1, b1, w2, b2)
    flops, nbytes = counts.intersect(n, k, d, hd)
    assert nbytes == _nbytes(x, w1, b1, w2, b2, out)
    # The plain version's two products, and the attention-weighted sum.
    assert flops == fc.get_total_flops() + 2 * n * k * d


@pytest.mark.parametrize("n,d,dl,dp", [(2048, 400, 1024, 64), (5, 16, 32, 8)])
def test_gather_fuse_count_reads_each_input_byte_once(n, d, dl, dp):
    from repro_torch.kernels.gather_fuse import gather_fuse_ref
    ids = torch.arange(n)
    h, z = torch.randn(n, d), torch.randn(n, dl)
    wp, bp, wf, bf = torch.randn(dl, dp), torch.randn(dp), torch.randn(d + dp, d), torch.randn(d)
    with FlopCounterMode(display=False) as fc:
        out = gather_fuse_ref(ids, h, z, wp, bp, wf, bf)
    flops, nbytes = counts.gather_fuse(n, d, dl, dp)
    # Each id, structural row and semantic row once (the rows gathered,
    # not the whole tables), the weights once, the output once.
    assert nbytes == _nbytes(ids, h, z, wp, bp, wf, bf, out)
    assert flops == fc.get_total_flops()
