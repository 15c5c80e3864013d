"""Core compute ops in plain PyTorch: the counterparts of
turboinfer_tpu/kernels/ops.py.

The `*_ref` functions are the golden forms the JAX package's jnp
references define (same masks, same f32 statistics, same dtype casts);
the CPU runs them, and each CUDA kernel is held against them on the
card. qmatmul / attention_* route through kernels/dispatch.py.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from turboinfer_tpu_torch.config import RopeMode
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor, dequantize

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm over the last axis: x * rsqrt(mean(x^2) + eps) * w with
    statistics in f32, output in x.dtype."""
    w = weight.to(torch.float32)
    if offset:
        w = w + offset
    return F.rms_norm(x.to(torch.float32), (x.shape[-1],), w, eps).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_GLU_ACTS = {"silu": silu, "gelu": gelu, "relu": torch.relu}


def glu(gate: torch.Tensor, up: torch.Tensor, act: str = "silu"
        ) -> torch.Tensor:
    """Gated FFN combine: act(gate) * up (silu = LLaMA SwiGLU)."""
    return _GLU_ACTS[act](gate) * up


def apply_softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None,
               scaling: Tuple[Tuple[str, float], ...] = ()) -> torch.Tensor:
    """Per-pair inverse frequencies theta^(-2i/d), f32. `scaling`:
    HF-style rope_scaling as (key, value) pairs; "linear" and "llama3"
    are ported, other types come in a later slice."""
    i = torch.arange(0, head_dim // 2, dtype=torch.float32, device=device)
    freqs = theta ** (-2.0 * i / head_dim)
    if scaling:
        d = dict(scaling)
        kind = str(d.get("rope_type", d.get("type", "linear")))
        factor = float(d.get("factor", 1.0))
        if kind == "linear":
            freqs = freqs / factor
        elif kind == "llama3":
            low = float(d.get("low_freq_factor", 1.0))
            high = float(d.get("high_freq_factor", 4.0))
            orig = float(d.get("original_max_position_embeddings", 8192))
            wavelen = 2.0 * math.pi / freqs
            smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
            scaled = (1 - smooth) * (freqs / factor) + smooth * freqs
            freqs = torch.where(wavelen > orig / low, freqs / factor,
                                torch.where(wavelen < orig / high, freqs,
                                            scaled))
        else:
            raise NotImplementedError(
                f"rope_scaling type '{kind}' is not ported yet "
                "(ported: linear, llama3)")
    return freqs


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0, mode: RopeMode = RopeMode.HALF,
                scaling: Tuple[Tuple[str, float], ...] = ()):
    """Full-width f32 tables (a, b) [B, S, 1, D] for `positions` [B, S]
    such that rope(x) = x * a + rotate(x) * b (see apply_rope); a
    forward builds them once and shares them across layers and heads."""
    freqs = rope_freqs(head_dim, theta, positions.device, scaling)
    angles = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mode == RopeMode.INTERLEAVED:
        return (torch.stack([cos, cos], -1).flatten(-2),
                torch.stack([-sin, sin], -1).flatten(-2))
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor],
               theta: float = 10000.0, mode: RopeMode = RopeMode.HALF,
               scaling: Tuple[Tuple[str, float], ...] = (),
               tables=None) -> torch.Tensor:
    """Rotary position embedding. x: [B, S, H, D]; positions: [B, S];
    tables: rope_tables(...) for these positions (built when None).

    HALF rotates (i, i + D/2) pairs, INTERLEAVED (2i, 2i+1) pairs. With
    rotate(x) = (x2, x1) and b = (-sin, sin) each output is x1*cos -
    x2*sin or x1*sin + x2*cos, the JAX package's products and sums
    exactly (negation is exact and the additions commute)."""
    D = x.shape[-1]
    a, b = tables or rope_tables(positions, D, theta, mode, scaling)
    xf = x.to(torch.float32)
    if mode == RopeMode.INTERLEAVED:
        rot = torch.stack([xf[..., 1::2], xf[..., 0::2]], -1).flatten(-2)
    else:
        rot = torch.cat([xf[..., D // 2:], xf[..., : D // 2]], -1)
    return (xf * a + rot * b).to(x.dtype)


def embed_lookup(embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding gather for fp tables and per-row int8 QEmbed tables
    (only the gathered rows dequantize)."""
    if isinstance(embed, QEmbed):
        rows = embed.data[tokens].to(torch.float32)
        return (rows * embed.scales[tokens]).to(dtype)
    return embed[tokens].to(dtype)


# -- quantized matmul --------------------------------------------------------

def qmatmul_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x @ dequant(qt): weight rounded to x.dtype, f32 sums, x.dtype out."""
    w = dequantize(qt, x.dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def qmatmul(x: torch.Tensor, w, layer_index: Optional[int] = None
            ) -> torch.Tensor:
    """[..., K] @ [K, N] for fp weights or QTensors (stacked weights take
    `layer_index`). QTensors go through the fused dequant-matmul."""
    if isinstance(w, QTensor):
        from turboinfer_tpu_torch.kernels import dispatch
        return dispatch.qmatmul(x, w, layer_index)
    if layer_index is not None and w.dim() == 3:
        w = w[layer_index]
    return torch.matmul(x.to(torch.float32),
                        w.to(x.dtype).to(torch.float32)).to(x.dtype)


# -- attention ---------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // hkv, dim=1)


def attention_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          positions: Optional[torch.Tensor] = None,
                          kv_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Full attention. q: [B, S, Hq, D], k/v: [B, Hkv, T, D] -> [B, S, Hq, D].
    Query s sits at positions[b, s] (default s); keys >= kv_len masked."""
    B, S, Hq, D = q.shape
    T = k.shape[2]
    k = _repeat_kv(k, Hq).to(torch.float32)
    v = _repeat_kv(v, Hq).to(torch.float32)
    qf = q.to(torch.float32) * (1.0 / math.sqrt(D))
    scores = torch.einsum("bshd,bhtd->bhst", qf, k)
    kpos = torch.arange(T, device=q.device)
    mask = None
    if causal:
        qpos = (torch.arange(S, device=q.device)[None, :].expand(B, S)
                if positions is None else positions)
        mask = qpos[:, None, :, None] >= kpos[None, None, None, :]
    if kv_len is not None:
        valid = kpos[None, None, None, :] < kv_len[:, None, None, None]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bshd", probs, v).to(q.dtype)


def attention_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len: torch.Tensor
                         ) -> torch.Tensor:
    """Single-token attention. q: [B, Hq, D]; k/v: [B, Hkv, T, D];
    kv_len: [B] valid slots (the current token included)."""
    B, Hq, D = q.shape
    T = k_cache.shape[2]
    k = _repeat_kv(k_cache, Hq).to(torch.float32)
    v = _repeat_kv(v_cache, Hq).to(torch.float32)
    qf = q.to(torch.float32) * (1.0 / math.sqrt(D))
    scores = torch.einsum("bhd,bhtd->bht", qf, k)
    valid = torch.arange(T, device=q.device)[None, None, :] < kv_len[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, v).to(q.dtype)

