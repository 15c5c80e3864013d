"""The port's tensor and expert parallelism over the other families, on
2 gloo ranks on the CPU, against the JAX package's (1, 2) mesh engine
(helpers in tests/test_torch_tp.py; f32, logits within 1e-4 of
max|logit|, greedy trajectories token for token):
  mixtral    int4 experts under EP (2 of 4 a rank): B=1 decode (the
             grouped product over the rank's local slots, the other
             rank's experts weighted 0) and B=2 (the E-loop over the
             rank's 2 experts);
  qwen2_moe  q/k/v biases and the shared expert (columns and rows; its
             partial rides the experts' all-reduce);
  olmoe      q/k norms over the whole projection, split with q/k (one
             all-reduce of the f32 sum of squares a norm), 8 experts;
  deepseek   MLA heads over tp with the latent replicated, EP, a dense
             first layer and shared experts;
  gpt_oss    heads, biases and sinks split by head, b_o after the
             all-reduce, experts replicated;
  gpt2       replicated whole under the mesh (ROADMAP §3 Decisions)
             against JAX's split of wo and lm_head.
"""

import pytest
import torch

from test_torch_tp import (TOKENS, case, close, jax_batch, jax_logits,
                           make_weights, same_on_ranks, spawn, wide_qk_norms)

torch.set_num_threads(2)

PROMPTS = [[1, 5, 7, 9], [3, 4, 5, 6, 7, 8, 9, 10, 11]]
ICFG = dict(max_seq_len=64, eos_token_id=-1)
SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, max_seq_len=64,
             rms_norm_eps=1e-6)
CFGS = {
    "mixtral": dict(SMALL, vocab_size=512, hidden_size=128, num_heads=4,
                    num_kv_heads=2, intermediate_size=256, num_experts=4,
                    experts_per_token=2, rope_theta=1e6,
                    architecture="mixtral", name="tiny-mixtral"),
    "qwen2_moe": dict(SMALL, num_heads=4, num_kv_heads=2,
                      intermediate_size=128, moe_intermediate_size=64,
                      num_experts=4, experts_per_token=2,
                      shared_expert_size=64, attn_bias=True,
                      norm_topk_prob=False, rope_theta=1e6,
                      architecture="qwen2_moe", name="tiny-qwen2-moe"),
    "olmoe": dict(SMALL, num_heads=4, num_kv_heads=4,
                  intermediate_size=128, moe_intermediate_size=64,
                  num_experts=8, experts_per_token=2, qk_norm=True,
                  norm_topk_prob=False, architecture="olmoe",
                  name="tiny-olmoe"),
    "deepseek": dict(SMALL, num_layers=3, num_heads=4, intermediate_size=128,
                     moe_intermediate_size=64, shared_expert_size=64,
                     num_experts=8, experts_per_token=2,
                     first_k_dense_replace=1, kv_lora_rank=32,
                     qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                     norm_topk_prob=False, architecture="deepseek_v2",
                     name="tiny-deepseek-v2"),
    "gpt_oss": dict(SMALL, vocab_size=512, hidden_size=256, num_heads=16,
                    num_kv_heads=2, head_dim=64, intermediate_size=128,
                    num_experts=4, experts_per_token=2, attn_bias=True,
                    sliding_window=8, sliding_window_pattern=2,
                    architecture="gpt_oss", name="tiny-gptoss"),
    "gpt2": dict(SMALL, vocab_size=300, num_heads=4, num_kv_heads=4,
                 intermediate_size=160, architecture="gpt2",
                 name="tiny-gpt2"),
}
NAMES = list(CFGS)


def family_case(name):
    cfg, jp = make_weights(CFGS[name], quant=name == "mixtral", seed=0,
                           edit=wide_qk_norms if name == "olmoe" else None)
    ops = [("logits", TOKENS % cfg.vocab_size), ("batch", PROMPTS, 10)]
    if name == "mixtral":
        ops.append(("batch", PROMPTS[:1], 10))     # B=1: the grouped GEMV
    return case(name, cfg, jp, ops, ICFG)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {n: family_case(n) for n in NAMES}
    return cases, spawn(str(tmp_path_factory.mktemp("fam")), 2, (1, 2),
                        cases.values())


@pytest.mark.parametrize("name", NAMES)
def test_tp2_family_logits_match_jax_mesh(ranks, name):
    cases, outs = ranks
    close(same_on_ranks(outs, name)[0],
          jax_logits(cases[name], TOKENS % cases[name]["cfg"]["vocab_size"]))


@pytest.mark.parametrize("name", NAMES)
def test_tp2_family_greedy_tokens_match_jax_mesh(ranks, name):
    cases, outs = ranks
    assert same_on_ranks(outs, name)[1] == jax_batch(cases[name], PROMPTS,
                                                     10)


def test_tp2_mixtral_batch_one_matches_jax_mesh(ranks):
    """B=1 decode: each rank's grouped product reads k planes of its
    own (clamped local slots, the other rank's experts gated to 0)."""
    cases, outs = ranks
    assert same_on_ranks(outs, "mixtral")[2] == jax_batch(
        cases["mixtral"], PROMPTS[:1], 10)
