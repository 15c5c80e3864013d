"""Sampling of the port against turboinfer_tpu/engine/sampling.py.

Random streams differ between the packages, so the filters and the
filtered distributions are compared (same seeded logits), never sampled
tokens. Logits carry exact ties to exercise the tie rules.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turboinfer_tpu.engine import sampling as js
from turboinfer_tpu_torch.engine import sampling as ts

torch.set_num_threads(2)


def _logits(seed, B=4, V=64):
    x = np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32)
    x[:, 10] = x[:, 11] = x[:, 12]           # a three-way tie
    x[0, 5] = x[0].max()                     # a tie at the top
    return x


@pytest.mark.parametrize("temp,k,p", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                      (1.3, 0, 0.8), (0.8, 50, 0.9),
                                      (0.0, 10, 0.5), (1.0, 64, 0.3)])
def test_filtered_dist_per_slot_matches(temp, k, p):
    x = _logits(int(temp * 10) + k)
    B = x.shape[0]
    args = (np.full(B, temp, np.float32), np.full(B, k, np.int32),
            np.full(B, p, np.float32))
    want = js.filtered_dist_per_slot(jnp.asarray(x), *map(jnp.asarray, args))
    got = ts.filtered_dist_per_slot(torch.from_numpy(x),
                                    *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_filtered_dist_per_row_knobs():
    x = _logits(9)
    temp = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    k = np.array([3, 0, 7, 64], np.int32)
    p = np.array([0.5, 0.9, 0.0, 0.95], np.float32)
    want = js.filtered_dist_per_slot(jnp.asarray(x), jnp.asarray(temp),
                                     jnp.asarray(k), jnp.asarray(p))
    got = ts.filtered_dist_per_slot(torch.from_numpy(x), torch.from_numpy(temp),
                                    torch.from_numpy(k), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("fn,arg", [("apply_top_k", 5), ("apply_top_k", 1),
                                    ("apply_top_p", 0.5), ("apply_top_p", 0.95),
                                    ("apply_min_p", 0.1),
                                    ("apply_temperature", 0.7)])
def test_filters_match(fn, arg):
    x = _logits(3)
    want = getattr(js, fn)(jnp.asarray(x), arg)
    got = getattr(ts, fn)(torch.from_numpy(x), arg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_penalties_match():
    x = _logits(4)
    counts = np.random.default_rng(5).integers(0, 3, size=x.shape).astype(np.int32)
    out = (counts > 1).astype(np.int32)
    want = js.apply_penalties(jnp.asarray(x), jnp.asarray(counts), 1.3, 0.4,
                              0.2, out_counts=jnp.asarray(out))
    got = ts.apply_penalties(torch.from_numpy(x), torch.from_numpy(counts),
                             1.3, 0.4, 0.2, out_counts=torch.from_numpy(out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sample_draws_inside_the_filtered_support():
    """Every sampled token has non-zero filtered probability, and greedy
    is the JAX argmax (first index on ties)."""
    x = _logits(6, B=8, V=200)
    B = x.shape[0]
    params = ts.SamplingParams(temperature=0.8, top_k=20, top_p=0.7)
    dist = ts.filtered_dist_per_slot(
        torch.from_numpy(x), torch.full((B,), 0.8), torch.full((B,), 20),
        torch.full((B,), 0.7))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = ts.sample(gen, torch.from_numpy(x), params)
        assert tok.dtype == torch.int32
        assert bool((dist[torch.arange(B), tok.long()] > 0).all())
    g = ts.sample(gen, torch.from_numpy(x), ts.SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(js.greedy(jnp.asarray(x))))
    lp = ts.token_logprob(torch.from_numpy(x), g)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(js.token_logprob(jnp.asarray(x),
                                                jnp.asarray(g.numpy()))),
        rtol=1e-6)
