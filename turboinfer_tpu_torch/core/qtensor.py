"""QTensor: group-wise quantized weight container, in PyTorch.

The byte format is turboinfer_tpu.core.qtensor's, bit for bit, so a
quantized weight crosses between the two packages unchanged:
  - int4 is packed two nibbles per uint8 along K, planar within each
    scale group: of a group's g rows, the first g/2 go to the LOW nibbles
    of the group's g/2 bytes and the last g/2 to the HIGH nibbles, each
    offset by +8 so the nibbles are unsigned.
  - scales are [G, N] for a 2-D weight and [L, G, N] for a layer stack,
    G = K / group_size; dequant is (q - zp) * scale.
Symmetric absmax quantization:
  int8: scale = absmax/127, q = clip(round(x/scale), -127, 127)
  int4: scale = absmax/7,   q = clip(round(x/scale), -7, 7)
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
            a leading [L] axis for a stack of layers
    scales: [G, N] (or [L, G, N]) float
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
        if not self.stacked:
            return self
        zp = None if self.zero_points is None else self.zero_points[li]
        return QTensor(data=self.data[li], scales=self.scales[li],
                       zero_points=zp, bits=self.bits,
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


def quantize(w: torch.Tensor, qtype: QuantType, *, group_size: int = 64,
             symmetric: bool = True, scale_dtype=torch.bfloat16,
             scale_method: str = "absmax") -> QTensor:
    """Group-wise symmetric absmax quantization of a 2-D weight [K, N]
    along K. Asymmetric and MSE-searched scales come in a later slice."""
    if w.dim() != 2:
        raise QuantizationError(f"quantize expects 2-D [K, N], got "
                                f"{tuple(w.shape)}")
    if qtype not in (QuantType.INT8, QuantType.INT4):
        raise QuantizationError(f"unsupported qtype {qtype}")
    if not symmetric or scale_method != "absmax":
        raise NotImplementedError(
            "only symmetric absmax quantization is ported so far")
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
    qmax = 127.0 if bits == 8 else 7.0
    absmax = xg.abs().amax(dim=1)                                  # [G, N]
    scale = torch.where(absmax > 0, absmax / qmax,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xg / scale[:, None, :]), -qmax, qmax)
    q = q.reshape(K, N).to(torch.int8)
    data = pack_int4(q, g) if bits == 4 else q
    return QTensor(data=data, scales=scale.to(scale_dtype), zero_points=None,
                   bits=bits, group_size=g, shape=(K, N))


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the fp weight [K, N] (or [L, K, N] for a stack)."""
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


class QEmbed(NamedTuple):
    """Per-row symmetric int8 embedding table: data [V, H] int8, scales
    [V, 1] f32. Lookup dequantizes only the gathered rows."""
    data: torch.Tensor
    scales: torch.Tensor


def quantize_embed(w: torch.Tensor) -> QEmbed:
    """[V, H] fp -> per-row symmetric int8."""
    wf = w.to(torch.float32)
    s = torch.clamp(wf.abs().amax(dim=1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QEmbed(data=q, scales=s)


def dequantize_embed(e: QEmbed, dtype=torch.float32) -> torch.Tensor:
    return (e.data.to(torch.float32) * e.scales).to(dtype)
