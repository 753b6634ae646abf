"""Shared set-up for the PyTorch port's parity tests (``test_torch_*.py``):
the same seeded graph, queries and weights built in both packages."""
import functools

import jax
import numpy as np
import torch

# Tolerances. fp32 operators with no special function agree to 1e-5. BetaE's
# distance builds betaln from lgamma and uses torch.digamma, which differ from
# jax.scipy.special.betaln/digamma by up to 5.3e-5 and 7.6e-6 over its clip
# range, so BetaE's distance-derived outputs get a looser tolerance.
FP32 = dict(rtol=1e-5, atol=1e-5)
BETAE_DISTANCE = dict(rtol=1e-4, atol=1e-3)
# The JAX package's executor tolerance with kernels on
# (tests/test_pallas_integration.py).
ENCODE = dict(rtol=2e-4, atol=2e-5)

FAMILIES = ["betae", "gqe", "complex"]
KG_SHAPE = (200, 10, 2400)  # the tiny_kg fixture's graph


@functools.lru_cache(maxsize=None)
def graphs(seed: int = 0):
    """(JAX-package graph, port graph) from one seed."""
    from repro.data import generate_synthetic_kg as j_gen
    from repro_torch.data import generate_synthetic_kg as t_gen

    return j_gen(*KG_SHAPE, seed=seed), t_gen(*KG_SHAPE, seed=seed)


def queries(n: int, seed: int = 0, patterns=None):
    """The same sampled queries from both packages' samplers."""
    from repro.sampling import OnlineSampler as JSampler
    from repro_torch.sampling import OnlineSampler as TSampler

    jkg, tkg = graphs()
    kw = {} if patterns is None else {"patterns": patterns}
    jq = [s.query for s in JSampler(jkg, seed=seed, **kw).sample_batch(n)]
    tq = [s.query for s in TSampler(tkg, seed=seed, **kw).sample_batch(n)]
    return jq, tq


@functools.lru_cache(maxsize=None)
def carried_models(name: str, dim: int = 16, seed: int = 0,
                   use_pallas: bool = False):
    """A JAX-package model with its params, and the port's model on the CPU
    carrying the same weights (cached: callers must not mutate them)."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro_torch.models import (ModelConfig as TCfg, make_model as t_make,
                                    params_from_numpy)

    jkg, _ = graphs()
    jm = j_make(name, JCfg(dim=dim, use_pallas=use_pallas))
    jp = jm.init_params(jax.random.PRNGKey(seed), jkg.n_entities,
                        jkg.n_relations)
    tm = t_make(name, TCfg(dim=dim), device="cpu")
    tp = params_from_numpy(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))

