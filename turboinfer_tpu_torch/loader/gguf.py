"""GGUF v3 reader/writer: the counterpart of
turboinfer_tpu/loader/gguf.py, byte for byte the same container and the
same block dequantization.

read_gguf parses the header, the metadata (arrays included: the
tokenizer's vocab, scores and merges) and the tensor index, in the
native library (turboinfer_tpu_torch/native.py) when it is built, else
in Python; the tensor data stays mapped. dequantize_ggml turns every
block type of _BLOCK_LAYOUT (Q4_0/1, Q5_0/1, Q8_0, Q2_K..Q8_K, F16,
BF16, F32/F64 and the ints) into f32, through the native OpenMP
dequantizer when it is built, else through the numpy forms below; the
two give identical output. Unsupported types raise ModelFormatError.
write_gguf writes F32/F16 tensors with any metadata. Everything here is
host-side numpy; loader/mapping.py moves the weights to the device.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from turboinfer_tpu_torch.utils.errors import ModelFormatError

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian (reference model_loader.cpp:22)
GGUF_VERSION = 3         # only v3, like the reference (model_loader.cpp:733)
DEFAULT_ALIGNMENT = 32   # reference model_loader.cpp:846-849

# -- metadata value types (GGUF spec) ---------------------------------------
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32, T_FLOAT32, T_BOOL, \
    T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = range(13)

_SCALAR_FMT = {
    T_UINT8: ("<B", 1), T_INT8: ("<b", 1), T_UINT16: ("<H", 2),
    T_INT16: ("<h", 2), T_UINT32: ("<I", 4), T_INT32: ("<i", 4),
    T_FLOAT32: ("<f", 4), T_BOOL: ("<B", 1), T_UINT64: ("<Q", 8),
    T_INT64: ("<q", 8), T_FLOAT64: ("<d", 8),
}

# -- ggml tensor types (GGUF spec) -------------------------------------------
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = \
    10, 11, 12, 13, 14, 15
GGML_I8, GGML_I16, GGML_I32, GGML_I64, GGML_F64 = 24, 25, 26, 27, 28
GGML_BF16 = 30

GGML_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
    GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0", GGML_Q8_1: "Q8_1",
    GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K", GGML_Q8_K: "Q8_K",
    GGML_I8: "I8", GGML_I16: "I16", GGML_I32: "I32", GGML_I64: "I64",
    GGML_F64: "F64",
}

# (block_elems, block_bytes) per type — spec values.
_BLOCK_LAYOUT = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_I8: (1, 1), GGML_I16: (1, 2), GGML_I32: (1, 4),
    GGML_I64: (1, 8), GGML_F64: (1, 8),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q2_K: (256, 84), GGML_Q3_K: (256, 110),
    GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
    GGML_Q8_K: (256, 292),
}


def tensor_nbytes(ggml_type: int, n_elems: int) -> int:
    if ggml_type not in _BLOCK_LAYOUT:
        name = GGML_TYPE_NAMES.get(ggml_type, str(ggml_type))
        raise ModelFormatError(f"unsupported GGML tensor type {name}")
    be, bb = _BLOCK_LAYOUT[ggml_type]
    if n_elems % be:
        raise ValueError(
            f"tensor size {n_elems} not a multiple of block size {be}")
    return (n_elems // be) * bb


@dataclass
class GGUFTensorInfo:
    name: str
    dims: Tuple[int, ...]   # GGUF order: dims[0] is the contiguous axis
    ggml_type: int
    offset: int             # relative to data-section start

    @property
    def n_elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def shape(self) -> Tuple[int, ...]:
        """Row-major numpy shape (GGUF dims reversed — the reference does
        the same reversal at model_loader.cpp:811)."""
        return tuple(reversed(self.dims))


@dataclass
class GGUFFile:
    metadata: Dict[str, Any]
    tensors: Dict[str, GGUFTensorInfo]
    path: str
    data_start: int
    alignment: int = DEFAULT_ALIGNMENT
    _mm: Optional[mmap.mmap] = field(default=None, repr=False)
    _fh: Optional[BinaryIO] = field(default=None, repr=False)

    def close(self):
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # numpy/jax views still alias the mapping (CPU jax arrays
                # are zero-copy); the OS mapping is released when the last
                # view is garbage-collected.
                pass
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- tensor access --------------------------------------------------
    def raw_tensor_bytes(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        nbytes = tensor_nbytes(info.ggml_type, info.n_elems)
        start = self.data_start + info.offset
        return np.frombuffer(self._mm, np.uint8, count=nbytes, offset=start)

    def tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Load + dequantize one tensor to `dtype`, shaped row-major."""
        info = self.tensors[name]
        raw = self.raw_tensor_bytes(name)
        flat = dequantize_ggml(raw, info.ggml_type, info.n_elems)
        return flat.reshape(info.shape).astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# Low-level readers
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, mm):
        self.mm = mm
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.mm[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("unexpected EOF in GGUF file")
        self.pos += n
        return b

    def scalar(self, vtype: int):
        fmt, size = _SCALAR_FMT[vtype]
        (v,) = struct.unpack(fmt, self.read(size))
        return bool(v) if vtype == T_BOOL else v

    def string(self) -> str:
        (n,) = struct.unpack("<Q", self.read(8))
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vtype: int):
        if vtype == T_STRING:
            return self.string()
        if vtype == T_ARRAY:
            (etype,) = struct.unpack("<I", self.read(4))
            (count,) = struct.unpack("<Q", self.read(8))
            if etype == T_STRING:
                return [self.string() for _ in range(count)]
            if etype == T_ARRAY:
                # nested arrays (rare); parse recursively
                return [self.value(T_ARRAY) for _ in range(count)]
            fmt, size = _SCALAR_FMT[etype]
            arr = np.frombuffer(self.read(size * count),
                                dtype=np.dtype(fmt[1:]), count=count)
            if etype == T_BOOL:
                return arr.astype(bool).tolist()
            return arr.tolist()
        return self.scalar(vtype)


def read_gguf(path: str) -> GGUFFile:
    """Parse header + metadata + tensor index; tensor data stays mmapped.

    The index parse runs in the native turboio library when available
    (native/turboio.cpp — the C++ counterpart of the reference's
    model_loader GGUF branch), else in pure Python below; results are
    identical (tests/test_native.py pins this)."""
    native_idx = None
    if os.environ.get("TURBOINFER_NO_NATIVE") != "1":
        try:
            from turboinfer_tpu_torch import native as tio
            native_idx = tio.gguf_index(path)
        except Exception:
            native_idx = None
    fh = open(path, "rb")
    try:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    except Exception:
        fh.close()
        raise
    if native_idx is not None:
        tensors = {
            name: GGUFTensorInfo(
                name=name, dims=tuple(int(d) for d in ent["dims"]),
                ggml_type=int(ent["type"]), offset=int(ent["offset"]))
            for name, ent in native_idx["tensors"].items()}
        return GGUFFile(metadata=native_idx["metadata"], tensors=tensors,
                        path=path,
                        data_start=int(native_idx["data_start"]),
                        alignment=int(native_idx["alignment"]),
                        _mm=mm, _fh=fh)
    r = _Reader(mm)
    magic, version = struct.unpack("<II", r.read(8))
    if magic != GGUF_MAGIC:
        raise ModelFormatError(f"not a GGUF file (magic 0x{magic:08x})")
    if version != GGUF_VERSION:
        raise ModelFormatError(f"unsupported GGUF version {version} (only v3)")
    n_tensors, n_kv = struct.unpack("<QQ", r.read(16))

    metadata: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        (vtype,) = struct.unpack("<I", r.read(4))
        metadata[key] = r.value(vtype)

    tensors: Dict[str, GGUFTensorInfo] = {}
    for _ in range(n_tensors):
        name = r.string()
        (n_dims,) = struct.unpack("<I", r.read(4))
        dims = struct.unpack(f"<{n_dims}Q", r.read(8 * n_dims))
        ttype, = struct.unpack("<I", r.read(4))
        offset, = struct.unpack("<Q", r.read(8))
        tensors[name] = GGUFTensorInfo(name=name, dims=tuple(int(d) for d in dims),
                                       ggml_type=int(ttype), offset=int(offset))

    alignment = int(metadata.get("general.alignment", DEFAULT_ALIGNMENT))
    data_start = (r.pos + alignment - 1) // alignment * alignment
    return GGUFFile(metadata=metadata, tensors=tensors, path=path,
                    data_start=data_start, alignment=alignment,
                    _mm=mm, _fh=fh)


# ---------------------------------------------------------------------------
# Block dequantization (vectorized numpy; GGML/GGUF public block formats)
# ---------------------------------------------------------------------------

def _f16(u16: np.ndarray) -> np.ndarray:
    return u16.view(np.float16).astype(np.float32)


def dequantize_ggml(raw: np.ndarray, ggml_type: int, n_elems: int
                    ) -> np.ndarray:
    """raw uint8 buffer -> flat fp32 array of n_elems."""
    if ggml_type == GGML_F32:
        return raw.view(np.float32)[:n_elems]
    if ggml_type == GGML_F16:
        return raw.view(np.float16)[:n_elems].astype(np.float32)
    if ggml_type == GGML_BF16:
        u = raw.view(np.uint16)[:n_elems].astype(np.uint32) << 16
        return u.view(np.float32)
    if ggml_type == GGML_I8:
        return raw.view(np.int8)[:n_elems].astype(np.float32)
    if ggml_type == GGML_I16:
        return raw.view(np.int16)[:n_elems].astype(np.float32)
    if ggml_type == GGML_I32:
        return raw.view(np.int32)[:n_elems].astype(np.float32)
    if ggml_type == GGML_I64:
        return raw.view(np.int64)[:n_elems].astype(np.float32)
    if ggml_type == GGML_F64:
        return raw.view(np.float64)[:n_elems].astype(np.float32)

    be, bb = _BLOCK_LAYOUT.get(ggml_type, (None, None))
    if be is None:
        name = GGML_TYPE_NAMES.get(ggml_type, str(ggml_type))
        raise ModelFormatError(f"unsupported GGML tensor type {name}")

    # Native fast path: the OpenMP block dequant (native/ggml_dequant
    # .cpp) runs at memory speed vs ~10-300 Melem/s for the numpy forms
    # below — the difference between minutes and seconds on a 7B
    # checkpoint. The numpy forms stay as the golden reference
    # (tests/test_torch_loader.py holds native == numpy bit for bit).
    from turboinfer_tpu_torch import native
    out = native.ggml_dequant(raw, ggml_type, n_elems)
    if out is not None:
        return out
    return dequantize_ggml_numpy(raw, ggml_type, n_elems)


def dequantize_ggml_numpy(raw: np.ndarray, ggml_type: int, n_elems: int
                          ) -> np.ndarray:
    """The numpy forms of dequantize_ggml's block types (the golden
    forms the native dequantizer is held against)."""
    be, bb = _BLOCK_LAYOUT.get(ggml_type, (None, None))
    if be is None or be == 1:
        return dequantize_ggml(raw, ggml_type, n_elems)

    nb = n_elems // be
    blocks = raw[: nb * bb].reshape(nb, bb)

    if ggml_type == GGML_Q4_0:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))        # [nb, 1]
        qs = blocks[:, 2:18]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [nb, 32]
        return (q * d).reshape(-1)[:n_elems]

    if ggml_type == GGML_Q4_1:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        m = _f16(blocks[:, 2:4].copy().view(np.uint16))
        qs = blocks[:, 4:20]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)
        return (q * d + m).reshape(-1)[:n_elems]

    if ggml_type == GGML_Q5_0:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        qh = blocks[:, 2:6].copy().view(np.uint32)              # [nb, 1]
        qs = blocks[:, 6:22]
        shifts = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> shifts) & 1).astype(np.uint8)            # [nb, 32]
        lo = (qs & 0x0F).astype(np.int16)
        hi = (qs >> 4).astype(np.int16)
        q = np.concatenate([lo, hi], axis=1)
        q = (q | (hbits.astype(np.int16) << 4)) - 16
        return (q.astype(np.float32) * d).reshape(-1)[:n_elems]

    if ggml_type == GGML_Q5_1:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        m = _f16(blocks[:, 2:4].copy().view(np.uint16))
        qh = blocks[:, 4:8].copy().view(np.uint32)
        qs = blocks[:, 8:24]
        shifts = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> shifts) & 1).astype(np.uint8)
        lo = (qs & 0x0F).astype(np.uint16)
        hi = (qs >> 4).astype(np.uint16)
        q = np.concatenate([lo, hi], axis=1)
        q = q | (hbits.astype(np.uint16) << 4)
        return (q.astype(np.float32) * d + m).reshape(-1)[:n_elems]

    if ggml_type == GGML_Q8_0:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        q = blocks[:, 2:34].view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)[:n_elems]

    if ggml_type == GGML_Q2_K:
        # 84 B/256: 16x u8 scales (lo nibble = scale, hi = min), 64 B of
        # 2-bit quants, fp16 d, fp16 dmin. Element order: per 128-half,
        # for shift in {0,2,4,6}: 16 elems from q[0:16] then 16 from
        # q[16:32], one 4-bit scale/min pair per 16.
        scs = blocks[:, 0:16]                                    # [nb,16]
        qs = blocks[:, 16:80]                                    # [nb,64]
        d = _f16(blocks[:, 80:82].copy().view(np.uint16))        # [nb,1]
        dmin = _f16(blocks[:, 82:84].copy().view(np.uint16))
        dl = d * (scs & 0x0F).astype(np.float32)                 # [nb,16]
        ml = dmin * (scs >> 4).astype(np.float32)
        out = np.empty((nb, 256), np.float32)
        for half in range(2):
            q = qs[:, 32 * half: 32 * (half + 1)]
            for j in range(4):
                is_ = 8 * half + 2 * j
                base = 128 * half + 32 * j
                lo = ((q[:, :16] >> (2 * j)) & 3).astype(np.float32)
                hi = ((q[:, 16:] >> (2 * j)) & 3).astype(np.float32)
                out[:, base: base + 16] = \
                    lo * dl[:, is_, None] - ml[:, is_, None]
                out[:, base + 16: base + 32] = \
                    hi * dl[:, is_ + 1, None] - ml[:, is_ + 1, None]
        return out.reshape(-1)[:n_elems]

    if ggml_type == GGML_Q3_K:
        # 110 B/256: 32 B high-bit mask, 64 B 2-bit low quants, 12 B
        # 6-bit signed scales (K-quant aux packing), fp16 d.
        # q = (lo | hi<<2) - 4 where hi comes from hmask bit
        # (half*4 + j); scale = 6-bit - 32.
        hm = blocks[:, 0:32]                                     # [nb,32]
        qs = blocks[:, 32:96]                                    # [nb,64]
        sc6 = _unpack_q3k_scales(blocks[:, 96:108])              # [nb,16]
        d = _f16(blocks[:, 108:110].copy().view(np.uint16))      # [nb,1]
        dl = d * (sc6 - 32.0)                                    # [nb,16]
        out = np.empty((nb, 256), np.float32)
        for half in range(2):
            q = qs[:, 32 * half: 32 * (half + 1)]
            for j in range(4):
                mbit = 4 * half + j
                is_ = 8 * half + 2 * j
                base = 128 * half + 32 * j
                lo = ((q[:, :16] >> (2 * j)) & 3).astype(np.int16) \
                    - (((hm[:, :16] >> mbit) & 1) ^ 1).astype(np.int16) * 4
                hi = ((q[:, 16:] >> (2 * j)) & 3).astype(np.int16) \
                    - (((hm[:, 16:] >> mbit) & 1) ^ 1).astype(np.int16) * 4
                out[:, base: base + 16] = \
                    lo.astype(np.float32) * dl[:, is_, None]
                out[:, base + 16: base + 32] = \
                    hi.astype(np.float32) * dl[:, is_ + 1, None]
        return out.reshape(-1)[:n_elems]

    if ggml_type == GGML_Q8_K:
        # 292 B/256: fp32 d, 256x int8, 16x int16 block sums (ignored
        # on dequant — they exist for dot-product kernels).
        d = blocks[:, 0:4].copy().view(np.float32)               # [nb,1]
        q = blocks[:, 4:260].view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)[:n_elems]

    if ggml_type == GGML_Q4_K:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))          # [nb,1]
        dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
        sc, mn = _unpack_kscales(blocks[:, 4:16])                # [nb,8] each
        qs = blocks[:, 16:144]                                   # [nb,128]
        out = np.empty((nb, 256), np.float32)
        # layout: per 64-elem chunk j: 32 low nibbles (scale 2j), then
        # 32 high nibbles (scale 2j+1), consuming 32 bytes of qs.
        for j in range(4):
            qb = qs[:, 32 * j: 32 * (j + 1)]
            d1 = d[:, 0] * sc[:, 2 * j]
            m1 = dmin[:, 0] * mn[:, 2 * j]
            d2 = d[:, 0] * sc[:, 2 * j + 1]
            m2 = dmin[:, 0] * mn[:, 2 * j + 1]
            out[:, 64 * j: 64 * j + 32] = \
                (qb & 0x0F).astype(np.float32) * d1[:, None] - m1[:, None]
            out[:, 64 * j + 32: 64 * j + 64] = \
                (qb >> 4).astype(np.float32) * d2[:, None] - m2[:, None]
        return out.reshape(-1)[:n_elems]

    if ggml_type == GGML_Q5_K:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
        sc, mn = _unpack_kscales(blocks[:, 4:16])
        qh = blocks[:, 16:48]                                    # [nb,32]
        qs = blocks[:, 48:176]                                   # [nb,128]
        out = np.empty((nb, 256), np.float32)
        for j in range(4):
            qb = qs[:, 32 * j: 32 * (j + 1)]
            h1 = ((qh >> (2 * j)) & 1).astype(np.float32) * 16.0
            h2 = ((qh >> (2 * j + 1)) & 1).astype(np.float32) * 16.0
            d1 = d[:, 0] * sc[:, 2 * j]
            m1 = dmin[:, 0] * mn[:, 2 * j]
            d2 = d[:, 0] * sc[:, 2 * j + 1]
            m2 = dmin[:, 0] * mn[:, 2 * j + 1]
            out[:, 64 * j: 64 * j + 32] = \
                ((qb & 0x0F).astype(np.float32) + h1) * d1[:, None] - m1[:, None]
            out[:, 64 * j + 32: 64 * j + 64] = \
                ((qb >> 4).astype(np.float32) + h2) * d2[:, None] - m2[:, None]
        return out.reshape(-1)[:n_elems]

    if ggml_type == GGML_Q6_K:
        ql = blocks[:, 0:128]
        qh = blocks[:, 128:192]
        sc = blocks[:, 192:208].view(np.int8).astype(np.float32)  # [nb,16]
        d = _f16(blocks[:, 208:210].copy().view(np.uint16))       # [nb,1]
        out = np.empty((nb, 256), np.float32)
        for half in range(2):                  # two 128-elem halves
            qlh = ql[:, 64 * half: 64 * (half + 1)]
            qhh = qh[:, 32 * half: 32 * (half + 1)]
            sch = sc[:, 8 * half: 8 * (half + 1)]
            base = 128 * half
            l = np.arange(32)
            is_ = l // 16                       # [32] in {0,1}
            q1 = ((qlh[:, :32] & 0x0F) | (((qhh >> 0) & 3) << 4)).astype(np.int16) - 32
            q2 = ((qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 3) << 4)).astype(np.int16) - 32
            q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int16) - 32
            q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int16) - 32
            out[:, base + 0: base + 32] = d * sch[:, is_ + 0] * q1
            out[:, base + 32: base + 64] = d * sch[:, is_ + 2] * q2
            out[:, base + 64: base + 96] = d * sch[:, is_ + 4] * q3
            out[:, base + 96: base + 128] = d * sch[:, is_ + 6] * q4
        return out.reshape(-1)[:n_elems]

    raise AssertionError("unreachable")


def _unpack_q3k_scales(s: np.ndarray) -> np.ndarray:
    """Unpack Q3_K's 12-byte 6-bit scale packing -> [nb, 16] floats in
    [0, 63] (caller subtracts the 32 bias).

    Byte-wise form of llama.cpp's kmask word shuffle: scale k (k = 4*w + i,
    w = output word, i = byte) = low/high nibble of s[i] / s[4+i] plus two
    high bits from s[8+i]."""
    s = s.astype(np.uint8)
    out = np.empty(s.shape[:1] + (16,), np.float32)
    for i in range(4):
        hib = s[:, 8 + i]
        out[:, i] = ((s[:, i] & 0x0F) | ((hib & 3) << 4)).astype(np.float32)
        out[:, 4 + i] = ((s[:, 4 + i] & 0x0F)
                         | (((hib >> 2) & 3) << 4)).astype(np.float32)
        out[:, 8 + i] = ((s[:, i] >> 4)
                         | (((hib >> 4) & 3) << 4)).astype(np.float32)
        out[:, 12 + i] = ((s[:, 4 + i] >> 4)
                          | (((hib >> 6) & 3) << 4)).astype(np.float32)
    return out


def _unpack_kscales(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the K-quant 12-byte 6-bit scale/min packing -> ([nb,8],[nb,8])."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = (s[:, j] & 63).astype(np.float32)
        mn[:, j] = (s[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)).astype(np.float32)
        mn[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


# ---------------------------------------------------------------------------
# Writer (tests + interop): F32/F16 tensors only, full metadata support.
# ---------------------------------------------------------------------------

def _write_string(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _value_type_of(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_INT64 if (v < 0 or v > 0xFFFFFFFF) else T_UINT32
    if isinstance(v, float):
        return T_FLOAT32
    if isinstance(v, str):
        return T_STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return T_ARRAY
    raise TypeError(f"cannot encode GGUF metadata value of type {type(v)}")


def _write_value(f, v: Any, vtype: Optional[int] = None):
    vtype = _value_type_of(v) if vtype is None else vtype
    f.write(struct.pack("<I", vtype))
    if vtype == T_STRING:
        _write_string(f, v)
    elif vtype == T_ARRAY:
        items = list(v)
        if items and isinstance(items[0], str):
            etype = T_STRING
        elif items and isinstance(items[0], bool):
            etype = T_BOOL
        elif items and isinstance(items[0], float):
            etype = T_FLOAT32
        elif isinstance(v, np.ndarray) and v.dtype == np.float32:
            etype = T_FLOAT32
        elif isinstance(v, np.ndarray) and v.dtype == np.int32:
            etype = T_INT32
        else:
            etype = T_INT32
        f.write(struct.pack("<IQ", etype, len(items)))
        for it in items:
            if etype == T_STRING:
                _write_string(f, it)
            else:
                fmt, _ = _SCALAR_FMT[etype]
                f.write(struct.pack(fmt, it))
    else:
        fmt, _ = _SCALAR_FMT[vtype]
        f.write(struct.pack(fmt, int(v) if vtype != T_FLOAT32 else float(v)))


def write_gguf(path: str, metadata: Dict[str, Any],
               tensors: Dict[str, np.ndarray],
               alignment: int = DEFAULT_ALIGNMENT) -> None:
    """Write a GGUF v3 file. Tensors are written as F32 or F16 based on
    their numpy dtype; `dims` are stored GGUF-order (reversed shape)."""
    # a caller-supplied general.alignment WINS (emitting both the
    # argument and the metadata copy would duplicate the key: readers
    # keep the later one while the data was padded with the former)
    metadata = dict(metadata)
    alignment = int(metadata.pop("general.alignment", alignment))
    with open(path, "wb") as f:
        f.write(struct.pack("<II", GGUF_MAGIC, GGUF_VERSION))
        f.write(struct.pack("<QQ", len(tensors), len(metadata) + 1))
        _write_string(f, "general.alignment")
        _write_value(f, alignment, T_UINT32)
        for k, v in metadata.items():
            _write_string(f, k)
            _write_value(f, v)

        offset = 0
        encoded: List[Tuple[str, np.ndarray, int, int]] = []
        for name, arr in tensors.items():
            arr = np.ascontiguousarray(arr)
            if arr.dtype == np.float16:
                ttype = GGML_F16
            else:
                arr = arr.astype(np.float32)
                ttype = GGML_F32
            encoded.append((name, arr, ttype, offset))
            nbytes = arr.nbytes
            offset += (nbytes + alignment - 1) // alignment * alignment

        for name, arr, ttype, off in encoded:
            _write_string(f, name)
            dims = tuple(reversed(arr.shape)) if arr.ndim else (1,)
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", ttype, off))

        pos = f.tell()
        pad = (pos + alignment - 1) // alignment * alignment - pos
        f.write(b"\x00" * pad)
        for name, arr, ttype, off in encoded:
            f.write(arr.tobytes())
            nbytes = arr.nbytes
            pad = (nbytes + alignment - 1) // alignment * alignment - nbytes
            f.write(b"\x00" * pad)
