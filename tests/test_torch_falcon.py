"""Falcon through the port's NeoX body (models/neox.py) against
turboinfer_tpu, and the published NeoX-family configs.

The tiny f32 Falcon configs of tests/test_torch_neox.py (its machinery
and checks, imported): the legacy multi_query layout (a group of 12
query heads on one kv head, one LayerNorm shared by the parallel
block), the new decoder architecture (GQA 8:2, ln_attn/ln_mlp) and
Falcon-RW (MHA, ALiBi with the slopes times D^-0.5, sequential). Each
is held against JAX as the other families are there: logits of a fresh
prefill, decode steps and a chunked prefill over model-dtype, int8 and
fp8 caches, greedy trajectories of generate_batch, quantize_params
codes, and the assembler on the checkpoint's own fused-qkv layout.
Also: the plain decode at Falcon-7B's group of 71 (D=64) and a 16:2
group against JAX's decode_pallas in interpret mode; falcon7b_config
and the other published configs of the chip phase against the JAX
loader's mapping of their config.json; and the paged scheduler's
refusal of a model without a paged forward.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turboinfer_tpu.kernels import ops as jops
from turboinfer_tpu.kernels.pallas import decode_attention as jda
from turboinfer_tpu.loader.mapping import config_from_hf_dict
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler, PagedContinuousScheduler)
from turboinfer_tpu_torch.kernels import decode_attention as tda
from turboinfer_tpu_torch.models import gpt2 as tgpt2
from turboinfer_tpu_torch.models import neox as tneox
from turboinfer_tpu_torch.models import registry

from test_torch_neox import (FAMILIES, KINDS, check_assembler,  # noqa: F401
                             check_forward, check_greedy,
                             jax_chunk_positions, models)

torch.set_num_threads(2)

KERNEL_RTOL = 2e-2       # the Pallas kernel's bf16 operands
FALCON = [n for n in FAMILIES if n.startswith("falcon")]


@pytest.mark.parametrize("kind", **KINDS)
@pytest.mark.parametrize("name", FALCON)
def test_falcon_forward_prefill_decode_chunked_logits(name, kind,
                                                     jax_chunk_positions):
    check_forward(name, kind)


@pytest.mark.parametrize("kind", **KINDS)
@pytest.mark.parametrize("name", FALCON)
def test_falcon_generate_batch_greedy_matches_jax(name, kind):
    check_greedy(name, kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FALCON)
def test_falcon_assembler_matches_jax(name, dtype):
    check_assembler(name, dtype)


@pytest.mark.parametrize("Hq,Hkv", [(71, 1), (16, 2)],
                         ids=["falcon7b_group71", "group8x2"])
def test_decode_plain_large_groups_match_decode_pallas(Hq, Hkv):
    """decode_attention on CPU tensors (decode_plain) at Falcon-7B's
    group of 71 query heads on one kv head, D=64, and at 16:2, against
    JAX's decode_pallas in interpret mode (its group padded to
    max(Gh, 8) rows a block), and exactly against JAX's jnp reference."""
    rng = np.random.default_rng(Hq)
    L, B, D, T = 2, 3, 64, 128
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    kv_len = np.asarray([1, 77, 128], np.int32)
    for li in (0, 1):
        want = jda.decode_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(kv_len),
                                 layer_index=jnp.int32(li), interpret=True)
        assert want is not None
        got = tda.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kv_len), li).numpy()
        want = np.asarray(want)
        assert np.abs(got - want).max() < KERNEL_RTOL * np.abs(want).max()
        np.testing.assert_allclose(got, np.asarray(jops.attention_decode_ref(
            jnp.asarray(q), jnp.asarray(k[li]), jnp.asarray(v[li]),
            jnp.asarray(kv_len))), rtol=1e-5, atol=1e-5)


# The published config.json of each configuration the chip phase runs,
# transcribed (the keys the loader reads).
PUBLISHED = {
    "falcon7b": ("tiiuae/falcon-7b", tconfig.falcon7b_config, {
        "model_type": "falcon", "alibi": False, "bias": False,
        "hidden_size": 4544, "layer_norm_epsilon": 1e-05,
        "multi_query": True, "new_decoder_architecture": False,
        "num_attention_heads": 71, "num_hidden_layers": 32,
        "parallel_attn": True, "vocab_size": 65024}),
    "gpt2_xl": ("gpt2-xl", tconfig.gpt2_xl_config, {
        "model_type": "gpt2", "n_embd": 1600, "n_head": 25, "n_layer": 48,
        "n_positions": 1024, "n_ctx": 1024, "n_inner": None,
        "layer_norm_epsilon": 1e-05, "vocab_size": 50257}),
    "pythia_6_9b": ("EleutherAI/pythia-6.9b", tconfig.pythia_6_9b_config, {
        "model_type": "gpt_neox", "hidden_size": 4096,
        "intermediate_size": 16384, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 2048, "num_attention_heads": 32,
        "num_hidden_layers": 32, "rotary_emb_base": 10000,
        "rotary_pct": 0.25, "tie_word_embeddings": False,
        "use_parallel_residual": True, "vocab_size": 50432}),
    "bloom_7b1": ("bigscience/bloom-7b1", tconfig.bloom_7b1_config, {
        "model_type": "bloom", "hidden_size": 4096, "n_head": 32,
        "n_layer": 30, "layer_norm_epsilon": 1e-05, "vocab_size": 250880}),
    "phi2": ("microsoft/phi-2", tconfig.phi2_config, {
        "model_type": "phi", "hidden_size": 2560, "intermediate_size": 10240,
        "layer_norm_eps": 1e-05, "max_position_embeddings": 2048,
        "num_attention_heads": 32, "num_hidden_layers": 32,
        "num_key_value_heads": 32, "partial_rotary_factor": 0.4,
        "rope_theta": 10000.0, "tie_word_embeddings": False,
        "vocab_size": 51200}),
}


@pytest.mark.parametrize("which", list(PUBLISHED))
def test_published_configs_match_the_jax_mapping(which):
    """Each config function against the JAX loader's mapping of the
    model's config.json, field by field, and routed to its body."""
    source, fn, hf = PUBLISHED[which]
    j = config_from_hf_dict(dict(hf, _name_or_path=source))
    t = fn()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "kv_heads", "head_dim_", "ffn_dim", "rope_theta",
              "rms_norm_eps", "max_seq_len", "parallel_residual", "alibi",
              "rotary_pct", "tie_embeddings", "architecture", "name"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.rope_mode.value == j.rope_mode.value
    mod = registry.get_model(t.architecture)
    assert mod is (tgpt2 if t.architecture == "gpt2" else tneox)
    mod.check_supported(t)


def test_falcon7b_shapes():
    """Falcon-7B's published shape: 71 query heads on one kv head of 64
    (a group of 71, under the decode kernel's bound), w_qkv 4544 x 4672,
    K = 4544 = 71 groups of 64."""
    c = tconfig.falcon7b_config()
    assert (c.num_heads // c.kv_heads, c.head_dim_) == (71, 64)
    assert c.q_dim + 2 * c.kv_dim == 4672 and c.hidden_size % 64 == 0
    assert c.num_heads // c.kv_heads <= tda.MAX_GROUP
    assert tneox.rotary_dims(c) == 64 and tneox.alibi_slopes(c, "cpu") \
        is None


@pytest.mark.parametrize("arch", ["gpt2", "falcon", "gpt_neox"])
def test_paged_scheduler_refuses_models_without_a_paged_forward(arch):
    """GPT-2 and the NeoX family have no forward_paged_decode: the paged
    scheduler raises at construction, as the JAX package's does, and the
    contiguous scheduler serves them."""
    name = {"gpt2": None, "falcon": "falcon_mqa",
            "gpt_neox": "neox_parallel"}[arch]
    if name is None:
        cfg = tconfig.ModelConfig(vocab_size=300, hidden_size=64,
                                  num_layers=1, num_heads=4,
                                  intermediate_size=128, max_seq_len=64,
                                  architecture="gpt2", dtype=torch.float32)
        params = tgpt2.init_params(cfg, device="cpu")
    else:
        _, _, cfg, params = models(name)
    icfg = InferenceConfig(max_seq_len=64, eos_token_id=-1)
    with pytest.raises(NotImplementedError, match="forward_paged_decode"):
        PagedContinuousScheduler(params, cfg, icfg, batch_slots=2,
                                 page_size=16, device="cpu")
    sched = ContinuousBatchingScheduler(params, cfg, icfg, batch_slots=2,
                                        device="cpu")
    rids = [sched.submit([1, 2, 3, 4], 6, temperature=0.0) for _ in range(3)]
    res = sched.run()
    assert all(len(res[r].tokens) == 10 for r in rids)
