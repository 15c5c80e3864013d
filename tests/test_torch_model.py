"""llama.forward of the port against turboinfer_tpu's on bridged params.

Configs: tiny f32, tiny int4 (the JAX quantizer's output, bridged), and
a narrow config with the 7B's head size D=128 and GQA (Hq=2, Hkv=1).
Logits are compared in f32 within 1e-4 (both packages run the same f32
reference arithmetic on the CPU; only summation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.quant.quantizer import quantize_params as j_quantize_params
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4


def jax_to_numpy(tree):
    """The JAX half of the bridge: a JAX param tree as numpy."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data), "scales": np.asarray(tree.scales),
                "zero_points": None if tree.zero_points is None
                else np.asarray(tree.zero_points), "bits": tree.bits,
                "group_size": tree.group_size, "shape": tree.shape}
    if isinstance(tree, JQEmbed):
        return {"data": np.asarray(tree.data),
                "row_scales": np.asarray(tree.scales)}
    return np.asarray(tree)


CONFIGS = {
    "tiny_f32": dict(cfg=dict(), quant=False),
    "tiny_int4": dict(cfg=dict(), quant=True),
    "gqa_d128": dict(cfg=dict(hidden_size=256, num_heads=2, num_kv_heads=1,
                              intermediate_size=512, vocab_size=512,
                              max_seq_len=128), quant=False),
}


def make_pair(name):
    spec = CONFIGS[name]
    jcfg = ti.tiny_config(dtype=jnp.float32, **spec["cfg"])
    tcfg = tconfig.tiny_config(dtype=torch.float32, **spec["cfg"])
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    if spec["quant"]:
        jp = j_quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                             group_size=64))
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("fuse", [False, True])
def test_forward_prefill_and_decode_logits(name, fuse):
    jcfg, tcfg, jp, tp = make_pair(name)
    if fuse:
        tp = prepare_params(tp)
    rng = np.random.default_rng(0)
    B, S, T = 3, 16, 32
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([16, 9, 1], np.int32)
    idx = np.maximum(lens - 1, 0)
    jc = jllama.init_cache(jcfg, B, max_seq=T, fused=False)
    jl, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), jc,
                            seq_lens=jnp.asarray(lens),
                            logit_idx=jnp.asarray(idx), fresh_prefill=True)
    tc = tllama.init_cache(tcfg, B, max_seq=T, device="cpu")
    tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(toks), tc,
                            seq_lens=torch.from_numpy(lens),
                            logit_idx=torch.from_numpy(idx),
                            fresh_prefill=True)
    assert tl.shape == (B, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), lens)
    # the head-major cache holds the same K/V
    np.testing.assert_allclose(tc.k.numpy()[:, :, :, :S],
                               np.asarray(jc.k)[:, :, :, :S], atol=1e-5)
    # two decode steps on the filled caches
    nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    for _ in range(2):
        jl, jc = jllama.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=1e-4)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)


def test_decode_from_a_bridged_jax_cache():
    """cache_from_numpy: the JAX package's head-major cache after its
    prefill drives the port's decode step to the same logits."""
    jcfg, tcfg, jp, tp = make_pair("gqa_d128")
    toks = np.random.default_rng(4).integers(1, 512, size=(2, 12)).astype(np.int32)
    jc = jllama.init_cache(jcfg, 2, max_seq=32, fused=False)
    _, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), jc,
                           seq_lens=jnp.asarray([12, 7], np.int32))
    tc = bridge.cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v),
                                 np.asarray(jc.length), device="cpu")
    nxt = np.array([[5], [9]], np.int32)
    jl, _ = jllama.forward(jp, jcfg, jnp.asarray(nxt), jc)
    tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=1e-4)
    np.testing.assert_array_equal(bridge.to_numpy(tc)["length"], [13, 8])


def test_chunked_prefill_matches_fresh():
    """The non-fresh prefill (per-row writes + stacked-cache attention)
    gives the fresh prefill's logits."""
    _, tcfg, _, tp = make_pair("gqa_d128")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, 512, size=(2, 16)).astype(np.int32))
    lens = torch.tensor([16, 11], dtype=torch.int32)
    c1 = tllama.init_cache(tcfg, 2, max_seq=32, device="cpu")
    full, _ = tllama.forward(tp, tcfg, toks, c1, seq_lens=lens,
                             fresh_prefill=True)
    c2 = tllama.init_cache(tcfg, 2, max_seq=32, device="cpu")
    a, c2 = tllama.forward(tp, tcfg, toks[:, :8], c2,
                           seq_lens=torch.tensor([8, 8], dtype=torch.int32))
    b, c2 = tllama.forward(tp, tcfg, toks[:, 8:], c2,
                           seq_lens=lens - 8)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy()[0],
                               full.numpy()[0], atol=LOGIT_ATOL)
    np.testing.assert_allclose(b.numpy()[1, :3], full.numpy()[1, 8:11],
                               atol=LOGIT_ATOL)


def test_unported_knobs_raise():
    cfg = tconfig.tiny_config(dtype=torch.float32, sliding_window=8)
    with pytest.raises(NotImplementedError):
        tllama.check_supported(cfg)
    with pytest.raises(NotImplementedError):
        tllama.check_supported(tconfig.tiny_config(attn_logit_softcap=30.0))
