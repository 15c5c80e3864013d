"""Core compute ops in plain PyTorch: the counterparts of
turboinfer_tpu/kernels/ops.py.

The `*_ref` functions are the golden forms the JAX package's jnp
references define (same masks, same f32 statistics, same dtype casts);
the CPU runs them, and each CUDA kernel is held against them on the
card. qmatmul / attention_* route through kernels/dispatch.py.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from turboinfer_tpu_torch.config import RopeMode
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor, dequantize

NEG_INF = -1e30

# Calibration hook (quant/calibrate.py): while a tap is installed, every
# qmatmul reports (x, w, layer_index) before computing; w is the weight
# as the caller passed it (the whole stack for a stacked weight).
_QMM_TAP = None


@contextlib.contextmanager
def qmm_tap(fn):
    """Install fn(x, w, layer_index) as the qmatmul tap for the block."""
    global _QMM_TAP
    prev = _QMM_TAP
    _QMM_TAP = fn
    try:
        yield
    finally:
        _QMM_TAP = prev


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm over the last axis: x * rsqrt(mean(x^2) + eps) * w with
    statistics in f32, output in x.dtype."""
    w = weight.to(torch.float32)
    if offset:
        w = w + offset
    return F.rms_norm(x.to(torch.float32), (x.shape[-1],), w, eps).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm over the last axis: (x - mean) * rsqrt(var + eps) * w
    (+ b), statistics in f32, output in x.dtype."""
    f32 = torch.float32
    return F.layer_norm(x.to(f32), (x.shape[-1],), weight.to(f32),
                        None if bias is None else bias.to(f32), eps
                        ).to(x.dtype)


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
    """Logit soft-capping (Gemma-2): cap * tanh(s / cap)."""
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes [num_heads] f32 (HF build_alibi_tensor, as
    Falcon-RW and BLOOM use them): 2^(-8i/n) over the largest power of
    two n <= num_heads, then the odd slopes of the next power of two for
    the heads past n. The score bias is slope * key position; softmax
    cancels the per-row constant that separates it from slope * (j - i)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** -(2.0 ** -(math.log2(closest) - 3))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != num_heads:
        extra = 2.0 ** -(2.0 ** -(math.log2(2 * closest) - 3))
        slopes += [extra ** i
                   for i in range(1, 2 * (num_heads - closest) + 1, 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def _alibi_bias(alibi: torch.Tensor, T: int, device) -> torch.Tensor:
    """slope * key position [Hq, T] f32."""
    return (alibi.to(device=device, dtype=torch.float32)[:, None]
            * torch.arange(T, dtype=torch.float32, device=device))


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None,
               scaling: Tuple[Tuple[str, float], ...] = ()) -> torch.Tensor:
    """Per-pair inverse frequencies theta^(-2i/d), f32. `scaling`:
    HF-style rope_scaling as (key, value) pairs: "linear", "llama3" and
    "yarn" (NTK-by-parts over the beta_fast/beta_slow correction range;
    `truncate` defaults to True, GPT-OSS sets it False); pair yarn with
    rope_attention_factor for the cos/sin amplitude."""
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
        elif kind == "yarn":
            beta_fast = float(d.get("beta_fast") or 32.0)
            beta_slow = float(d.get("beta_slow") or 1.0)
            orig = float(d.get("original_max_position_embeddings", 4096))

            def corr_dim(rot):
                return (head_dim * math.log(orig / (rot * 2 * math.pi))
                        / (2 * math.log(theta)))
            low, high = corr_dim(beta_fast), corr_dim(beta_slow)
            if bool(d.get("truncate", True)):
                low, high = math.floor(low), math.ceil(high)
            low, high = max(low, 0.0), min(high, head_dim - 1.0)
            if low == high:
                high += 0.001
            ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
            extrap_w = 1.0 - ramp
            freqs = (freqs / factor) * (1 - extrap_w) + freqs * extrap_w
        else:
            raise NotImplementedError(
                f"rope_scaling type '{kind}' is not ported yet "
                "(ported: linear, llama3, yarn)")
    return freqs


def rope_attention_factor(scaling: Tuple[Tuple[str, float], ...]) -> float:
    """YaRN cos/sin amplitude ("attention_factor", else 0.1 * mscale *
    ln(factor) + 1); 1.0 for every other scaling."""
    d = dict(scaling)
    if str(d.get("rope_type", d.get("type", ""))) != "yarn":
        return 1.0
    if d.get("attention_factor") is not None:
        return float(d["attention_factor"])
    factor = float(d.get("factor", 1.0))

    def get_mscale(scale, m=1.0):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0
    mscale, mscale_all = d.get("mscale"), d.get("mscale_all_dim")
    if mscale and mscale_all:
        return float(get_mscale(factor, float(mscale))
                     / get_mscale(factor, float(mscale_all)))
    return float(get_mscale(factor))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0, mode: RopeMode = RopeMode.HALF,
                scaling: Tuple[Tuple[str, float], ...] = ()):
    """Full-width f32 tables (a, b) [B, S, 1, D] for `positions` [B, S]
    such that rope(x) = x * a + rotate(x) * b (see apply_rope); a
    forward builds them once and shares them across layers and heads.
    cos and sin carry rope_attention_factor (yarn only)."""
    freqs = rope_freqs(head_dim, theta, positions.device, scaling)
    angles = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    mscale = rope_attention_factor(scaling)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
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
    if _QMM_TAP is not None:
        _QMM_TAP(x, w, layer_index)
    if isinstance(w, QTensor):
        from turboinfer_tpu_torch.kernels import dispatch
        return dispatch.qmatmul(x, w, layer_index)
    if layer_index is not None and w.dim() == 3:
        w = w[layer_index]
    return torch.matmul(x.to(torch.float32),
                        w.to(x.dtype).to(torch.float32)).to(x.dtype)


def qmatmul_grouped(x: torch.Tensor, w, slots: torch.Tensor) -> torch.Tensor:
    """out[g] = x[g] @ W[slots[g]] for G slots of a stacked weight (MoE
    decode: the k routed experts). x: [G, ..., K]; slots: [G] int device
    tensor -> [G, ..., N]. QTensors go to the grouped kernel; fp weights
    gather the slots and run one batched product."""
    if isinstance(w, QTensor):
        from turboinfer_tpu_torch.kernels import dispatch
        return dispatch.qmatmul_grouped(x, w, slots)
    wg = w[slots.long()].to(x.dtype).to(torch.float32)          # [G, K, N]
    return torch.einsum("g...k,gkn->g...n", x.to(torch.float32),
                        wg).to(x.dtype)


# -- attention ---------------------------------------------------------------

def e4m3_to_float(u8: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """float8_e4m3fn bit patterns (uint8) -> values with integer math, the
    port of the JAX package's e4m3_to_bf16: (8 + m) * 2^(e - 10) for e >
    0, m * 2^-9 for subnormals, exact for every finite code; the two NaN
    codes 0x7F/0xFF decode as +-480, as the Pallas kernels (and the CUDA
    kernels here) read them."""
    qi = u8.to(torch.int32)
    e = (qi >> 3) & 0xF
    m = qi & 0x7
    mf = torch.where(e == 0, m, m + 8).to(torch.float32)
    val = torch.ldexp(mf, torch.where(e == 0, 1, e) - 10)
    return torch.where((qi >> 7) == 1, -val, val).to(out_dtype)


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // hkv, dim=1)


def attention_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          positions: Optional[torch.Tensor] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          alibi: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Full attention. q: [B, S, Hq, D], k/v: [B, Hkv, T, D] -> [B, S, Hq, D].
    Query s sits at positions[b, s] (default s); keys >= kv_len masked.
    softcap: cap * tanh(s / cap) on the scaled scores, before the mask;
    window (causal only): a query at p sees keys > p - window; alibi:
    [Hq] slopes, slope * key position added after the softcap."""
    B, S, Hq, D = q.shape
    T = k.shape[2]
    k = _repeat_kv(k, Hq).to(torch.float32)
    v = _repeat_kv(v, Hq).to(torch.float32)
    qf = q.to(torch.float32) * (1.0 / math.sqrt(D))
    scores = apply_softcap(torch.einsum("bshd,bhtd->bhst", qf, k), softcap)
    if alibi is not None:
        scores = scores + _alibi_bias(alibi, T, q.device)[None, :, None, :]
    kpos = torch.arange(T, device=q.device)
    mask = None
    if window is not None and not causal:
        raise NotImplementedError(
            "sliding_window attention requires causal=True")
    if causal:
        qpos = (torch.arange(S, device=q.device)[None, :].expand(B, S)
                if positions is None else positions)
        mask = qpos[:, None, :, None] >= kpos[None, None, None, :]
        if window is not None:
            mask = mask & (kpos[None, None, None, :]
                           > qpos[:, None, :, None] - window)
    if kv_len is not None:
        valid = kpos[None, None, None, :] < kv_len[:, None, None, None]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bshd", probs, v).to(q.dtype)


def attention_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len: torch.Tensor,
                         window: Optional[int] = None,
                         sinks: Optional[torch.Tensor] = None,
                         softcap: Optional[float] = None,
                         alibi: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Single-token attention. q: [B, Hq, D]; k/v: [B, Hkv, T, D];
    kv_len: [B] valid slots (the current token included). window: keys
    [kv_len - window, kv_len) only. sinks: [Hq] per-head sink logits
    (GPT-OSS): the softmax runs over [scores, sink] and the sink adds no
    value (attention_decode_fused_ref of the JAX package, head-major).
    softcap: cap * tanh(s / cap) on the scaled scores, before the mask;
    alibi: [Hq] slopes, slope * key position added after the softcap."""
    B, Hq, D = q.shape
    T = k_cache.shape[2]
    k = _repeat_kv(k_cache, Hq).to(torch.float32)
    v = _repeat_kv(v_cache, Hq).to(torch.float32)
    qf = q.to(torch.float32) * (1.0 / math.sqrt(D))
    scores = apply_softcap(torch.einsum("bhd,bhtd->bht", qf, k), softcap)
    if alibi is not None:
        scores = scores + _alibi_bias(alibi, T, q.device)[None]
    t = torch.arange(T, device=q.device)[None, None, :]
    valid = t < kv_len[:, None, None]
    if window is not None:
        valid = valid & (t >= kv_len[:, None, None] - window)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if sinks is None:
        probs = torch.softmax(scores, dim=-1)
    else:
        s0 = sinks.to(device=q.device, dtype=torch.float32)[None, :, None]
        m = torch.maximum(scores.amax(-1, keepdim=True), s0)
        p = torch.exp(scores - m)
        probs = p / (torch.exp(s0 - m) + p.sum(-1, keepdim=True))
    return torch.einsum("bht,bhtd->bhd", probs, v).to(q.dtype)



def _gather_pages(pages: torch.Tensor, block_table: torch.Tensor
                  ) -> torch.Tensor:
    """[P, Hkv, page, D] pages through a [B, n] table (ids clamped to
    [0, P-1]) -> contiguous [B, Hkv, n * page, D]."""
    P, Hkv, page, D = pages.shape
    B, n = block_table.shape
    t = block_table.long().clamp(0, P - 1)
    return pages[t].transpose(1, 2).reshape(B, Hkv, n * page, D)


def attention_paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_table: torch.Tensor,
                               kv_len: torch.Tensor,
                               window: Optional[int] = None,
                               sinks: Optional[torch.Tensor] = None,
                               softcap: Optional[float] = None
                               ) -> torch.Tensor:
    """Single-token attention over ONE layer's paged cache: gather the
    sequence's pages, then attention_decode_ref (window, sinks and
    softcap as there). q: [B, Hq, D]; k/v_pages: [P, Hkv, page, D];
    block_table: [B, max_pages] (-1 = unassigned); kv_len: [B] (the
    current token included). An fp8 pool (uint8 e4m3 bits) is decoded after the gather
    (e4m3_to_float); an int8 pool needs scales and raises."""
    if k_pages.dtype == torch.int8:
        raise ValueError("attention_paged_decode_ref takes no int8 pool "
                         "(it has no scale pages)")

    def gather(pages):
        g = _gather_pages(pages, block_table)
        return e4m3_to_float(g, q.dtype) if g.dtype == torch.uint8 \
            else g.to(q.dtype)
    return attention_decode_ref(q, gather(k_pages), gather(v_pages), kv_len,
                                window=window, sinks=sinks, softcap=softcap)


def attention_paged_verify_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_table: torch.Tensor,
                               kv_len: torch.Tensor,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None
                               ) -> torch.Tensor:
    """Multi-query paged attention (speculative verify). q: [B, G, Hq, D],
    the G chunk tokens already written into their pages; kv_len [B]
    includes them, so query g sits at kv_len - G + g (causal among the
    chunk). Gathers the pages, then attention_prefill_ref (window and
    softcap as there)."""
    G = q.shape[1]
    k = _gather_pages(k_pages, block_table).to(q.dtype)
    v = _gather_pages(v_pages, block_table).to(q.dtype)
    positions = (kv_len - G)[:, None] + torch.arange(
        G, device=q.device)[None, :]
    return attention_prefill_ref(q, k, v, causal=True, positions=positions,
                                 kv_len=kv_len, window=window,
                                 softcap=softcap)
