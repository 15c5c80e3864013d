"""Synthetic models, the counterparts of turboinfer_tpu/loader/synthetic.py:
create_synthetic_model, a random fp LLaMA-class model, and
create_synthetic_quantized_model, a random-weight quantized model of any
ported family built directly in the packed format on the device: a
7B, Mixtral, Gemma-2-27B or Falcon-7B fixture never exists in fp. Values are random
(uniform bytes, scales 0.01; a bf16 router for MoE); use it to measure
speed, not accuracy. Each stacked weight is drawn in place into its
packed storage (randint writes the uint8/int8 tensor itself), so no
layer ever has a bf16 or f32 copy; the transient peak is the f32 draw of
the embedding table. The llama-family knobs add their slots after the
head: q/k/v biases (attn_bias, N(0, 0.02^2) bf16), q/k norms
(qk_norm, [L, D]) and sandwich norms (post_norms, [L, H]); every norm is
ones, or zeros under norm_offset (Gemma's w - 1), as the JAX package's
init_params makes them. A tied model keeps its own quantized lm_head,
as quant/quantizer.py makes one from the tied table. GPT-2 and the NeoX
family (GPT-NeoX, Phi, Falcon, BLOOM) are drawn by their module's
init_params (through the registry) with its products taken from the
same packed draws: LayerNorm weights ones, biases zeros, the bf16
embedding (and GPT-2's positions) from init_params' own seeded stream;
a head whose vocab is not a multiple of 8 (GPT-2's 50257) stays fp, as
the qmm kernels take N % 8 == 0 only. A MoE model with a shared expert
(Qwen2-MoE) adds packed "ws_gate"/"ws_up"/"ws_down" [L, ...] and a bf16
"shared_gate" [L, H, 1] of 0.01; DeepSeek (config.kv_lora_rank) is the
JAX package's MLA fixture: packed wq (or wq_a/wq_b), wkv_a, wo, experts,
shared experts and the "dense_layers" group's FFN; bf16 wkv_b, router,
norms and embedding; an f32 zero router_bias. The llama-family knob
slots (biases, q/k and sandwich norms) are the port's additions to the
JAX package's tree, which draws none of them.
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
    from turboinfer_tpu_torch.models import gpt2, neox, registry
    dev = resolve_device(device)
    c = config
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

    def experts(layers, n, Fe):
        """4-D expert stacks [n, E, ...], the layout of
        quant/quantizer._quantize_experts (gate and up drawn as one
        "we_gateup" stack under fused_experts)."""
        E = c.num_experts
        if fused_experts:
            layers["we_gateup"] = rq(H, 2 * Fe, lead=(n, E))
        else:
            layers["we_gate"] = rq(H, Fe, lead=(n, E))
            layers["we_up"] = rq(H, Fe, lead=(n, E))
        layers["we_down"] = rq(Fe, H, lead=(n, E))

    def bf16(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)

    if c.kv_lora_rank:
        return _synthetic_deepseek(c, rq, experts, bf16, dev)
    model = registry.get_model(c.architecture)
    if model in (gpt2, neox):
        # the family's own tree, every [.., K, N] product a packed draw
        params = model.init_params(
            c, seed=seed, device=dev, dtype=torch.bfloat16,
            matmul=lambda shape, fan_in: rq(shape[-2], shape[-1],
                                            lead=tuple(shape[:-2])))
        if V % 8:
            # the qmm kernels take N % 8 == 0 only (GPT-2's 50257): the
            # head stays fp, the tied table or a bf16 draw
            if isinstance(params["lm_head"], QTensor):
                params["lm_head"] = (0.02 * torch.randn(
                    (H, V), generator=gen, device=dev)).to(torch.bfloat16)
        elif not isinstance(params["lm_head"], QTensor):   # tied: its own
            params["lm_head"] = rq(H, V, lead=())
        return ModelData(params=params, config=config,
                         source_format="synthetic-quantized")

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
        # MoE: a bf16 router, the expert stacks and the shared expert
        layers["router"] = bf16(L, H, E)
        experts(layers, L, c.moe_intermediate_size or F)
        if c.shared_expert_size:
            Fs = c.shared_expert_size
            layers.update(ws_gate=rq(H, Fs), ws_up=rq(H, Fs),
                          ws_down=rq(Fs, H),
                          shared_gate=torch.full((L, H, 1), 0.01,
                                                 dtype=torch.bfloat16,
                                                 device=dev))
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


def _synthetic_deepseek(c: ModelConfig, rq, experts, bf16, dev) -> ModelData:
    """The JAX package's DeepSeek fixture (_synthetic_quantized_deepseek):
    packed wq/wq_a/wq_b, wkv_a, wo, experts, shared experts and the dense
    group's FFN; bf16 wkv_b, router, norms and embedding; f32 router_bias."""
    H, V, L = c.hidden_size, c.vocab_size, c.num_layers
    nH = c.num_heads
    dn, dr, dv, lr = (c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                      c.kv_lora_rank)
    E, kd = c.num_experts, c.first_k_dense_replace
    Lm, Fd = L - kd, c.ffn_dim

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    def attn(n):
        g = {"attn_norm": ones(n, H), "ffn_norm": ones(n, H),
             "wkv_a": rq(H, lr + dr, lead=(n,)), "kv_a_norm": ones(n, lr),
             "wkv_b": bf16(n, lr, nH * (dn + dv)),
             "wo": rq(nH * dv, H, lead=(n,))}
        if c.q_lora_rank:
            qr = c.q_lora_rank
            g.update(wq_a=rq(H, qr, lead=(n,)), q_a_norm=ones(n, qr),
                     wq_b=rq(qr, nH * (dn + dr), lead=(n,)))
        else:
            g["wq"] = rq(H, nH * (dn + dr), lead=(n,))
        return g

    embed = bf16(V, H)
    layers = attn(Lm)
    layers.update(router=bf16(Lm, H, E),
                  router_bias=torch.zeros((Lm, E), dtype=torch.float32,
                                          device=dev))
    experts(layers, Lm, c.moe_intermediate_size or Fd)
    if c.shared_expert_size:
        Fs = c.shared_expert_size
        layers.update(ws_gate=rq(H, Fs, lead=(Lm,)),
                      ws_up=rq(H, Fs, lead=(Lm,)),
                      ws_down=rq(Fs, H, lead=(Lm,)))
    params = {"embed": embed, "layers": layers, "final_norm": ones(H),
              "lm_head": rq(H, V, lead=())}
    if kd:
        dense = attn(kd)
        dense.update(w_gate=rq(H, Fd, lead=(kd,)), w_up=rq(H, Fd, lead=(kd,)),
                     w_down=rq(Fd, H, lead=(kd,)))
        params["dense_layers"] = dense
    return ModelData(params=params, config=c,
                     source_format="synthetic-quantized")
