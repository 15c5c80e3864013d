"""Synthetic models, the counterparts of turboinfer_tpu/loader/synthetic.py:
create_synthetic_model, a random fp LLaMA-class model, and
create_synthetic_quantized_model, a random-weight quantized LLaMA-class
or MoE model built directly in the packed format on the device: a
7B, Mixtral or Gemma-2-27B fixture never exists in fp. Values are random
(uniform bytes, scales 0.01; a bf16 router for MoE); use it to measure
speed, not accuracy. Each stacked weight is drawn in place into its
packed storage (randint writes the uint8/int8 tensor itself), so no
layer ever has a bf16 or f32 copy; the transient peak is the f32 draw of
the embedding table. The llama-family knobs add their slots after the
head: q/k/v biases (attn_bias, N(0, 0.02^2) bf16), q/k norms
(qk_norm, [L, D]) and sandwich norms (post_norms, [L, H]); every norm is
ones, or zeros under norm_offset (Gemma's w - 1), as the JAX package's
init_params makes them. A tied model keeps its own quantized lm_head,
as quant/quantizer.py makes one from the tied table.
"""

from __future__ import annotations

from typing import Optional

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.loader.loader import ModelData
from turboinfer_tpu_torch.utils.device import resolve_device


def create_synthetic_model(vocab_size: int = 1000, hidden_size: int = 128,
                           num_layers: int = 2, num_heads: int = 4,
                           intermediate_size: Optional[int] = None,
                           max_seq_len: int = 2048, seed: int = 0,
                           dtype=torch.bfloat16, name: str = "synthetic",
                           device="cuda") -> ModelData:
    """A random-weight fp LLaMA-class model (llama.init_params from
    `seed`) with the built-in tokenizer: the JAX package's
    create_synthetic_model, with torch's random stream."""
    from turboinfer_tpu_torch.models import llama
    from turboinfer_tpu_torch.tokenizer.bpe import BuiltinTokenizer
    config = ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden_size,
        num_layers=num_layers, num_heads=num_heads, num_kv_heads=num_heads,
        intermediate_size=intermediate_size or 4 * hidden_size,
        max_seq_len=max_seq_len, dtype=dtype, name=name,
        architecture="llama")
    return ModelData(params=llama.init_params(config, seed=seed,
                                              device=device),
                     config=config,
                     tokenizer=BuiltinTokenizer(vocab_size=vocab_size),
                     source_format="synthetic")


def create_synthetic_quantized_model(config: ModelConfig, bits: int = 4,
                                     group_size: int = 64, device="cuda",
                                     seed: int = 0,
                                     fused_experts: bool = False
                                     ) -> ModelData:
    """bits 4 (packed uint8) or 8 (int8 codes), symmetric. fused_experts:
    a MoE model's gate and up experts are drawn as one "we_gateup" stack
    [L, E, H, 2F], the layout prepare_params fuses them into, so the
    split stacks and their fused copy never live side by side
    (Mixtral-8x7B int8: 2 x 15 GB each); the values differ from the
    split draw's."""
    dev = resolve_device(device)
    c = config
    if c.kv_lora_rank or c.shared_expert_size:
        raise NotImplementedError("MLA and shared-expert fixtures are not "
                                  "ported yet")
    L, H, V, F = c.num_layers, c.hidden_size, c.vocab_size, c.ffn_dim
    QD, KVD, G = c.q_dim, c.kv_dim, group_size
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rq(K, N, lead=(L,)):
        if bits == 4:
            data = torch.randint(0, 255, lead + (K // 2, N), generator=gen,
                                 dtype=torch.uint8, device=dev)
        else:
            data = torch.randint(-127, 127, lead + (K, N), generator=gen,
                                 dtype=torch.int8, device=dev)
        scales = torch.full(lead + (K // G, N), 0.01, dtype=torch.bfloat16,
                            device=dev)
        return QTensor(data=data, scales=scales, zero_points=None,
                       bits=bits, group_size=G, shape=(K, N))

    def ones(*shape):
        # Gemma stores norm weights as w - 1
        return (torch.zeros if c.norm_offset else torch.ones)(
            shape, dtype=torch.bfloat16, device=dev)

    # draw order: embedding, attention, FFN (router and experts for
    # MoE), head
    embed = torch.randn((V, H), generator=gen, device=dev).mul_(0.02).to(
        torch.bfloat16)                 # one f32 temporary, scaled in place
    layers = {"attn_norm": ones(L, H), "ffn_norm": ones(L, H),
              "wq": rq(H, QD), "wk": rq(H, KVD), "wv": rq(H, KVD),
              "wo": rq(QD, H)}
    E = c.num_experts
    if E:
        # MoE: a bf16 router and 4-D expert stacks [L, E, ...], the layout
        # of quant/quantizer._quantize_experts.
        Fe = c.moe_intermediate_size or F
        layers["router"] = (0.02 * torch.randn((L, H, E), generator=gen,
                                               device=dev)).to(torch.bfloat16)
        if fused_experts:
            layers["we_gateup"] = rq(H, 2 * Fe, lead=(L, E))
        else:
            layers["we_gate"] = rq(H, Fe, lead=(L, E))
            layers["we_up"] = rq(H, Fe, lead=(L, E))
        layers["we_down"] = rq(Fe, H, lead=(L, E))
    else:
        layers.update(w_gate=rq(H, F), w_up=rq(H, F), w_down=rq(F, H))
    params = {"embed": embed, "layers": layers, "final_norm": ones(H),
              "lm_head": rq(H, V, lead=())}
    if c.attn_bias:
        for name, n in (("b_q", QD), ("b_k", KVD), ("b_v", KVD)):
            layers[name] = (0.02 * torch.randn((L, n), generator=gen,
                                               device=dev)).to(torch.bfloat16)
    if c.qk_norm:
        layers.update(q_norm=ones(L, c.head_dim_), k_norm=ones(L, c.head_dim_))
    if c.post_norms:
        layers.update(post_attn_norm=ones(L, H), post_ffn_norm=ones(L, H))
    return ModelData(params=params, config=config,
                     source_format="synthetic-quantized")
