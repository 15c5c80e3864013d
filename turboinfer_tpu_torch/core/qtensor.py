"""QTensor: group-wise quantized weight container, in PyTorch.

The byte format is turboinfer_tpu.core.qtensor's, bit for bit, so a
quantized weight crosses between the two packages unchanged:
  - int4 is packed two nibbles per uint8 along K, planar within each
    scale group: of a group's g rows, the first g/2 go to the LOW nibbles
    of the group's g/2 bytes and the last g/2 to the HIGH nibbles, each
    offset by +8 so the nibbles are unsigned.
  - scales are [G, N] for a 2-D weight, [L, G, N] for a layer stack and
    [L, E, G, N] for a stack of MoE experts, G = K / group_size; dequant
    is (q - zp) * scale.
Symmetric absmax quantization:
  int8: scale = absmax/127, q = clip(round(x/scale), -127, 127)
  int4: scale = absmax/7,   q = clip(round(x/scale), -7, 7)
(or the "mse" shrink search over the absmax scale); asymmetric
quantization adds zero points (see quantize).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import QuantType
from turboinfer_tpu_torch.utils.errors import QuantizationError


def pack_int4(q: torch.Tensor, group_size: int) -> torch.Tensor:
    """Pack int values in [-8, 7] two per byte along axis 0, planar
    within each group of `group_size` rows. q: [K, ...] -> [K/2, ...]."""
    K = q.shape[0]
    g = group_size if group_size > 0 else K
    if g % 2 or K % g:
        raise QuantizationError(
            f"int4 pack needs even group_size dividing K (K={K}, g={g})")
    u = (q.to(torch.int32) + 8).to(torch.uint8)
    tail = tuple(q.shape[1:])
    ug = u.reshape((K // g, g) + tail)
    lo = ug[:, : g // 2]
    hi = ug[:, g // 2:]
    return (lo | (hi << 4)).reshape((K // 2,) + tail)


def unpack_int4(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Inverse of pack_int4: [K/2, ...] uint8 -> [K, ...] int8 in [-8, 7]."""
    K = 2 * packed.shape[0]
    g = group_size if group_size > 0 else K
    tail = tuple(packed.shape[1:])
    pg = packed.reshape((K // g, g // 2) + tail)
    lo = (pg & 0x0F).to(torch.int8) - 8
    hi = ((pg >> 4) & 0x0F).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=1).reshape((K,) + tail)


@dataclasses.dataclass
class QTensor:
    """A quantized weight of logical shape (K, N), K the contraction axis.

    data:   int8 [K, N] (bits=8) or packed uint8 [K/2, N] (bits=4), with
            a leading [L] axis for a stack of layers, or [L, E] for the
            experts of a MoE model (flat() views those as an [L*E] stack)
    scales: [G, N] (or [L, G, N], [L, E, G, N]) float
    zero_points: optional, same shape as scales (None for symmetric)
    """

    data: torch.Tensor
    scales: torch.Tensor
    zero_points: Optional[torch.Tensor]
    bits: int
    group_size: int
    shape: Tuple[int, int]

    @property
    def stacked(self) -> bool:
        return self.data.dim() == 3

    def layer(self, li: int) -> "QTensor":
        """Layer `li` of a stacked QTensor, as views (no copy)."""
        if self.data.dim() == 4:
            raise ValueError("a 4-D expert stack has no layer view; index "
                             "slot layer*E + expert of flat()")
        if not self.stacked:
            return self
        zp = None if self.zero_points is None else self.zero_points[li]
        return QTensor(data=self.data[li], scales=self.scales[li],
                       zero_points=zp, bits=self.bits,
                       group_size=self.group_size, shape=self.shape)

    def flat(self) -> "QTensor":
        """A 4-D expert stack [L, E, ...] as the flat [L*E, ...] stack
        the kernels index by slot layer*E + expert: a free reshape of
        contiguous data. Any other QTensor is returned as it is."""
        if self.data.dim() != 4:
            return self

        def flat(a):
            return None if a is None else a.reshape((-1,) + a.shape[2:])
        return QTensor(data=flat(self.data), scales=flat(self.scales),
                       zero_points=flat(self.zero_points), bits=self.bits,
                       group_size=self.group_size, shape=self.shape)

    def to(self, device) -> "QTensor":
        zp = None if self.zero_points is None else self.zero_points.to(device)
        return QTensor(data=self.data.to(device),
                       scales=self.scales.to(device), zero_points=zp,
                       bits=self.bits, group_size=self.group_size,
                       shape=self.shape)

    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        n += self.scales.numel() * self.scales.element_size()
        if self.zero_points is not None:
            n += self.zero_points.numel() * self.zero_points.element_size()
        return n


def concat_n(qts) -> QTensor:
    """Concatenate QTensors along N (the output axis); for 2-D and
    stacked layouts alike. The fused product is numerically identical
    to the separate ones."""
    first = qts[0]
    for qt in qts[1:]:
        if (qt.bits != first.bits or qt.group_size != first.group_size
                or qt.shape[0] != first.shape[0]
                or qt.data.dim() != first.data.dim()
                or qt.scales.dtype != first.scales.dtype
                or (qt.zero_points is None) != (first.zero_points is None)):
            raise QuantizationError(
                "concat_n needs matching K/bits/group_size/scale-dtype/"
                "symmetry across operands")
    data = torch.cat([qt.data for qt in qts], dim=-1)
    scales = torch.cat([qt.scales for qt in qts], dim=-1)
    zp = None if first.zero_points is None else torch.cat(
        [qt.zero_points for qt in qts], dim=-1)
    N = sum(qt.shape[1] for qt in qts)
    return QTensor(data=data, scales=scales, zero_points=zp,
                   bits=first.bits, group_size=first.group_size,
                   shape=(first.shape[0], N))


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace(start, stop, num) bit for bit in f32: the JAX package
    compiles it as start * (1 - t) + stop * t, t = i * f32(1 / (num - 1)),
    each product and sum rounded to f32 (torch.linspace rounds
    differently, a few ulp off)."""
    f32 = torch.float32
    div = num - 1
    t = torch.arange(div, dtype=f32) * (torch.tensor(1.0, dtype=f32)
                                        / torch.tensor(float(div), dtype=f32))
    a = torch.tensor(start, dtype=f32)
    b = torch.tensor(stop, dtype=f32)
    return torch.cat([a * (1 - t) + b * t, b[None]])


def _mse_scale(xg: torch.Tensor, base_scale: torch.Tensor, qmax: float,
               num_grid: int = 16, shrink_min: float = 0.30,
               moments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-group scale minimising the round-trip squared error, the port
    of the JAX package's _mse_scale: shrink factors c from 1.0 down to
    shrink_min applied to the absmax scale (c = 1 first, so never worse
    than absmax). xg: [G, g, N] f32; base_scale: [G, N]. moments: [G, g]
    per-input-channel activation second moments E[x_k^2] (calibration,
    quant/calibrate.py) weighting each channel's error, floored at 1% of
    their mean so channels calibration never drove still count."""
    best, best_err = base_scale, None
    m = None
    if moments is not None:
        mf = moments.to(torch.float32)
        m = torch.maximum(mf, 0.01 * mf.mean())[:, :, None]       # [G, g, 1]
    for c in _linspace_f32(1.0, shrink_min, num_grid).to(xg.device):
        s = torch.clamp(base_scale * c, min=1e-12)
        q = torch.clamp(torch.round(xg / s[:, None, :]), -qmax, qmax)
        sq = torch.square(q * s[:, None, :] - xg)
        if m is not None:
            sq = sq * m
        err = sq.sum(dim=1)                                        # [G, N]
        if best_err is None:
            best_err = err
        else:
            best = torch.where(err < best_err, s, best)
            best_err = torch.minimum(err, best_err)
    return best


def _div(a: torch.Tensor, v: float) -> torch.Tensor:
    """a / v as an IEEE division on every device: CUDA turns a Python
    scalar divisor into a multiply by its reciprocal, which rounds
    differently from the JAX package's division (and from the CPU's)."""
    return a / torch.full_like(a, v)


def quantize(w: torch.Tensor, qtype: QuantType, *, group_size: int = 64,
             symmetric: bool = True, scale_dtype=torch.bfloat16,
             scale_method: str = "absmax",
             weight_moments: Optional[torch.Tensor] = None) -> QTensor:
    """Group-wise quantization of a 2-D weight [K, N] along K, the JAX
    package's arithmetic op for op. Symmetric: absmax (or the "mse"
    shrink search) scales, codes in [-127, 127] / [-7, 7], no zero
    points. Asymmetric: scale = (max - min) / 255 (/ 15 for int4),
    zp_f = round(min / scale) - lo, codes round(x / scale) - zp_f
    clipped to [-128, 127] / [-8, 7], zero points stored as -zp_f in
    scale_dtype, so dequant is (q - zp) * scale. weight_moments: [K]
    per-input-channel E[x^2] from calibration; the symmetric scale
    search then weighs each channel's error by them (see _mse_scale)."""
    if w.dim() != 2:
        raise QuantizationError(f"quantize expects 2-D [K, N], got "
                                f"{tuple(w.shape)}")
    if qtype not in (QuantType.INT8, QuantType.INT4):
        raise QuantizationError(f"unsupported qtype {qtype}")
    if scale_method not in ("absmax", "mse"):
        raise QuantizationError(f"unknown scale_method '{scale_method}'")
    if (scale_method == "mse" or weight_moments is not None) \
            and not symmetric:
        raise QuantizationError(
            "scale_method='mse' / calibrated quantization requires "
            "symmetric quantization")
    K, N = w.shape
    bits = 8 if qtype == QuantType.INT8 else 4
    g = group_size if group_size > 0 else K
    if K % g:
        raise QuantizationError(f"group_size {g} must divide K={K}")
    if bits == 4 and (K % 2 or g % 2):
        raise QuantizationError(
            f"int4 needs even K and even group_size dividing K "
            f"(K={K}, group_size={g})")
    xg = w.to(torch.float32).reshape(K // g, g, N)
    mg = None
    if weight_moments is not None:
        mf = torch.as_tensor(weight_moments, dtype=torch.float32,
                             device=w.device).reshape(-1)
        if mf.shape[0] != K:
            raise QuantizationError(
                f"weight_moments length {mf.shape[0]} != K={K}")
        mg = mf.reshape(K // g, g)
    zp = None
    if symmetric:
        qmax = 127.0 if bits == 8 else 7.0
        absmax = xg.abs().amax(dim=1)                              # [G, N]
        scale = torch.where(absmax > 0, _div(absmax, qmax),
                            torch.ones_like(absmax))
        if scale_method == "mse" or mg is not None:
            scale = _mse_scale(xg, scale, qmax, moments=mg)
        q = torch.clamp(torch.round(xg / scale[:, None, :]), -qmax, qmax)
    else:
        levels, lo, hi = (255.0, -128.0, 127.0) if bits == 8 else \
            (15.0, -8.0, 7.0)
        mn = xg.amin(dim=1)
        rng = xg.amax(dim=1) - mn
        scale = torch.where(rng > 0, _div(rng, levels), torch.ones_like(rng))
        zp_f = torch.round(mn / scale) - lo                        # [G, N]
        q = torch.clamp(torch.round(xg / scale[:, None, :])
                        - zp_f[:, None, :] + 0.0, lo, hi)
        zp = (-zp_f).to(scale_dtype)
    q = q.reshape(K, N).to(torch.int8)
    data = pack_int4(q, g) if bits == 4 else q
    return QTensor(data=data, scales=scale.to(scale_dtype), zero_points=zp,
                   bits=bits, group_size=g, shape=(K, N))


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the fp weight [K, N] (or [L, K, N] / [L, E, K, N] for
    a stack)."""
    K, N = qt.shape
    g = qt.group_size
    lead = tuple(qt.data.shape[:-2])
    if qt.bits == 4:
        packed = qt.data.reshape((-1,) + tuple(qt.data.shape[-2:]))
        q = torch.stack([unpack_int4(p, g) for p in packed]).reshape(
            lead + (K, N))
    else:
        q = qt.data
    qg = q.to(torch.float32).reshape(lead + (K // g, g, N))
    if qt.zero_points is not None:
        qg = qg - qt.zero_points.to(torch.float32).unsqueeze(-2)
    w = qg * qt.scales.to(torch.float32).unsqueeze(-2)
    return w.reshape(lead + (K, N)).to(dtype)


def quantization_error(w: torch.Tensor, qt: QTensor) -> float:
    """Relative L2 reconstruction error ||w - dequant(qt)|| / ||w||."""
    wf = w.to(torch.float32)
    num = torch.linalg.vector_norm(wf - dequantize(qt, torch.float32))
    den = torch.clamp(torch.linalg.vector_norm(wf), min=1e-12)
    return float(num / den)


def estimate_compression_ratio(shape: Tuple[int, int], qtype: QuantType,
                               group_size: int = 64, symmetric: bool = True,
                               from_dtype_bytes: int = 4) -> float:
    """Theoretical compression ratio against an fp source, counting
    scales and zero points (at 4 bytes each, as the JAX package counts
    them)."""
    K, N = shape
    G = -(-K // (group_size if group_size > 0 else K))
    if qtype == QuantType.INT8:
        data = K * N
    elif qtype == QuantType.INT4:
        data = (K // 2) * N
    elif qtype == QuantType.FLOAT16:
        data = 2 * K * N
    else:
        return 1.0
    meta = G * N * 4 * (1 if symmetric else 2)
    return (from_dtype_bytes * K * N) / float(data + meta)


def _np(t: torch.Tensor):
    """Host numpy view of a tensor; bf16 as its uint16 bits."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("uint16")
    return t.numpy()


def to_numpy_blobs(qt: QTensor):
    """Host-side numpy arrays of a QTensor's storage (bf16 scales and
    zero points as their uint16 bits) for persistence."""
    blobs = {"data": _np(qt.data), "scales": _np(qt.scales)}
    if qt.zero_points is not None:
        blobs["zero_points"] = _np(qt.zero_points)
    return blobs


def from_numpy_blobs(blobs, bits: int, group_size: int,
                     shape: Tuple[int, int], scale_dtype=torch.bfloat16,
                     device="cpu") -> QTensor:
    """Inverse of to_numpy_blobs: uint16 scale / zero-point blobs are
    read as scale_dtype bits (bf16), any other dtype as it is."""
    def t(a):
        a = torch.from_numpy(a.copy())
        return (a.view(scale_dtype) if a.dtype == torch.uint16 else a
                ).to(device)
    zp = blobs.get("zero_points")
    return QTensor(data=t(blobs["data"]), scales=t(blobs["scales"]),
                   zero_points=None if zp is None else t(zp), bits=bits,
                   group_size=group_size, shape=tuple(shape))


class QEmbed(NamedTuple):
    """Per-row symmetric int8 embedding table: data [V, H] int8, scales
    [V, 1] f32. Lookup dequantizes only the gathered rows."""
    data: torch.Tensor
    scales: torch.Tensor


def quantize_embed(w: torch.Tensor) -> QEmbed:
    """[V, H] fp -> per-row symmetric int8."""
    wf = w.to(torch.float32)
    s = _div(torch.clamp(wf.abs().amax(dim=1, keepdim=True), min=1e-12),
             127.0)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QEmbed(data=q, scales=s)


def dequantize_embed(e: QEmbed, dtype=torch.float32) -> torch.Tensor:
    return (e.data.to(torch.float32) * e.scales).to(dtype)
