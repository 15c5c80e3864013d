"""GPT-2-class decoder in PyTorch: counterpart of
turboinfer_tpu/models/gpt2.py.

Pre-LN blocks x + attn(ln1(x)), x + mlp(ln2(x)) with biases everywhere,
MHA through a fused q|k|v product, a GELU (tanh) MLP, learned positional
embeddings added to the token embedding (positions clipped into the
table, as the JAX model takes them) and a tied lm_head. The parameter
tree is models/neox.py's plus "pos_embed" [max_seq_len, H], and the
blocks are neox.run_blocks without rotary, ALiBi or the parallel
residual: the same kernels (qmm for the four products and the head,
flash, decode and the cache writes through llama.attend) over the same
head-major cache of the model dtype, bf16, int8 or fp8. There is no paged
forward, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.kernels import ops
from turboinfer_tpu_torch.models import neox
from turboinfer_tpu_torch.models.common import KVCache
from turboinfer_tpu_torch.models.common import (  # noqa: F401
    param_bytes, param_count, reset_cache)
from turboinfer_tpu_torch.utils.errors import ConfigError

SUPPORTS_INT8_KV = True
ARCHITECTURES = ("gpt2",)


def check_supported(config: ModelConfig) -> None:
    """Raise for a config this body does not run: another architecture,
    MoE or MLA knobs (NotImplementedError), or grouped heads (ConfigError:
    GPT-2's q|k|v split is three equal parts of the hidden size)."""
    if config.architecture not in ARCHITECTURES:
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not GPT-2")
    for name, off in neox._UNPORTED:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to the PyTorch package yet")
    if config.kv_heads != config.num_heads \
            or config.q_dim != config.hidden_size:
        raise ConfigError(f"gpt2 is multi-head attention over the hidden "
                          f"size: {config.num_heads} query heads, "
                          f"{config.kv_heads} kv heads, q_dim {config.q_dim}, "
                          f"hidden {config.hidden_size}")


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """Head-major [L, B, H, T, D] cache of zeros on `device`."""
    return neox.init_cache(config, batch_size, max_seq, dtype, device)


def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None, matmul=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's structure (neox.init_params
    with learned positions [max_seq_len, H] and lm_head = embed.T);
    matmul as there, for the four stacked products."""
    check_supported(config)
    return neox.draw_params(config, seed, device, dtype, matmul,
                            qkv=3 * config.hidden_size, pos_embed=True)


def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Forward over `tokens` [B, S] appending to `cache` (queries at
    cache.length[b] + s, which also index the position table), with the
    contract of llama.forward."""
    check_supported(config)
    S = tokens.shape[1]
    positions = cache.length[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None, :]
    table = params["pos_embed"]
    x = ops.embed_lookup(params["embed"], tokens, config.dtype)
    x = x + table[positions.clamp(0, table.shape[0] - 1).long()].to(
        config.dtype)
    return neox.run_blocks(params, config, x, cache, seq_lens, logit_idx,
                           fresh_prefill, rotary=False, alibi=False,
                           parallel=False)


def forward_no_cache(params: Dict[str, Any], config: ModelConfig,
                     tokens: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cacheless full-sequence forward (JAX gpt2.forward_no_cache) ->
    logits [B, S, V] f32."""
    B, S = tokens.shape
    cache = init_cache(config, B, max_seq=S, device=tokens.device)
    logits, _ = forward(params, config, tokens, cache, seq_lens=seq_lens,
                        fresh_prefill=True)
    return logits
