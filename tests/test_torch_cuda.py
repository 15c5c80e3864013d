"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a GPU (the kernels have no CPU
mode). The file imports no JAX, so it also runs on a GPU machine that
has none:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.kernels import (cache_write, decode_attention,
                                          flash_attention, paged_attention,
                                          qmm)

torch.set_num_threads(2)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 128, 1000), (8, 256, 512),
                                   (40, 512, 136)])
def test_cuda_qmm_matches_plain(M, K, N):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(M)
    qt = QTensor(data=torch.randint(0, 256, (2, K // 2, N), generator=gen,
                                    dtype=torch.uint8, device="cuda"),
                 scales=torch.full((2, K // 64, N), 0.01, dtype=torch.bfloat16,
                                   device="cuda"),
                 zero_points=None, bits=4, group_size=64, shape=(K, N))
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    got = qmm.qmm_int4(x, qt, 1).float()
    want = qmm.qmatmul_plain(x, qt, 1).float()
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def _expert_stack(gen, n, K, N):
    """A flat [n, K/2, N] int4 stack with random bytes and scales."""
    return QTensor(data=torch.randint(0, 256, (n, K // 2, N), generator=gen,
                                      dtype=torch.uint8, device="cuda"),
                   scales=(0.005 + 0.01 * torch.rand(
                       (n, K // 64, N), generator=gen, device="cuda")
                   ).to(torch.bfloat16),
                   zero_points=None, bits=4, group_size=64, shape=(K, N))


@pytest.mark.cuda
@pytest.mark.parametrize("G,M,K,N,slots", [
    (2, 1, 256, 512, [5, 0]), (2, 1, 1024, 136, [3, 3]),
    (3, 1, 512, 384, [11, 0, 11]), (4, 3, 256, 256, [2, 9, 0, 7]),
    (2, 16, 128, 64, [1, 4]), (2, 1, 256, 64, [-3, 99])])
def test_cuda_qmm_grouped_matches_plain(G, M, K, N, slots):
    """The grouped kernel reads each group's slot on the device: first
    and last planes, repeated slots, up to 16 rows per group, and
    out-of-range ids clamped into the stack as the plain version
    clamps them."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(G * M + K)
    qt = _expert_stack(gen, 12, K, N)
    x = torch.randn((G, M, K), generator=gen, device="cuda").to(torch.bfloat16)
    s = torch.tensor(slots, dtype=torch.int32, device="cuda")
    before = qmm.qmm_int4_grouped.launches
    got = qmm.qmm_int4_grouped(x, qt, s).float()
    want = qmm.qmatmul_grouped_plain(x, qt, s).float()
    assert got.shape == (G, M, N) and qmm.qmm_int4_grouped.launches == before + 1
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
    # each group equals the dense kernel on its (clamped) plane
    for g, sl in enumerate(slots):
        one = qmm.qmm_int4(x[g], qt, min(max(sl, 0), 11)).float()
        assert (got[g] - one).abs().max().item() <= \
            2e-2 * one.abs().max().item()


@pytest.mark.cuda
def test_cuda_qmm_grouped_refuses_unsupported_inputs():
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    gen = torch.Generator(device="cuda").manual_seed(3)
    qt = _expert_stack(gen, 4, 128, 64)
    s = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    x = torch.randn((2, 1, 128), device="cuda").to(torch.bfloat16)
    with pytest.raises(KernelError):          # M = 17 > 16 rows per group
        qmm.qmm_int4_grouped(torch.zeros((2, 17, 128), dtype=torch.bfloat16,
                                         device="cuda"), qt, s)
    int8 = QTensor(data=torch.zeros((4, 128, 64), dtype=torch.int8,
                                    device="cuda"), scales=qt.scales,
                   zero_points=None, bits=8, group_size=64, shape=(128, 64))
    with pytest.raises(KernelError):          # int8 weights
        qmm.qmm_int4_grouped(x, int8, s)
    four_d = QTensor(data=qt.data.reshape(2, 2, 64, 64),
                     scales=qt.scales.reshape(2, 2, 2, 64), zero_points=None,
                     bits=4, group_size=64, shape=(128, 64))
    with pytest.raises(KernelError):          # an unflattened expert stack
        qmm.qmm_int4_grouped(x, four_d, s)
    with pytest.raises(KernelError):          # slots on the host
        qmm.qmm_int4_grouped(x, qt, s.cpu())
    assert torch.equal(qmm.qmm_int4_grouped(x, four_d.flat(), s),
                       qmm.qmm_int4_grouped(x, qt, s))


def _qtensor(gen, lead, K, N, bits, asym, g=64):
    """A random [*lead, K(/2), N] weight: int4 bytes or int8 codes (-128
    included), scales in [0.005, 0.015), integer zero points when asym."""
    if bits == 4:
        data = torch.randint(0, 256, lead + (K // 2, N), generator=gen,
                             dtype=torch.uint8, device="cuda")
    else:
        data = torch.randint(-128, 128, lead + (K, N), generator=gen,
                             dtype=torch.int8, device="cuda")
    sshape = lead + (K // g, N)
    scales = (0.005 + 0.01 * torch.rand(sshape, generator=gen,
                                        device="cuda")).to(torch.bfloat16)
    zp = torch.randint(-12, 13, sshape, generator=gen, device="cuda").to(
        torch.bfloat16) if asym else None
    return QTensor(data=data, scales=scales, zero_points=zp, bits=bits,
                   group_size=g, shape=(K, N))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", [(8, False), (8, True), (4, True)],
                         ids=["int8", "int8_zp", "int4_zp"])
@pytest.mark.parametrize("M,K,N,g", [
    (1, 2880, 136, 64), (8, 512, 2880, 64), (13, 256, 1000, 128),
    (40, 2880, 2880, 64), (300, 512, 200, 256), (17, 4096, 64, 4096)])
def test_cuda_qmm_int8_and_zero_points_match_plain(bits, asym, M, K, N, g):
    """int8 and zero-point weights on both paths (GEMV at M <= 16, tensor
    cores above): K=2880 (45 groups, no power of two), 64- and 8-column
    tails, g up to per-channel (g = K), layer 1 of a stack."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(M + K + bits)
    qt = _qtensor(gen, (2,), K, N, bits, asym, g)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wrapper = qmm.qmm_int8 if bits == 8 else qmm.qmm_int4
    before = wrapper.launches
    got = wrapper(x, qt, 1).float()
    want = qmm.qmatmul_plain(x, qt, 1).float()
    assert wrapper.launches == before + 1
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


# The tensor-core path's edges (M > 16): token tiles of 64 and 128 and
# their tails (17, 65, 129, 257, 1000), weight rows that TMA cannot
# describe (N = 136, 1000: not a multiple of 16 bytes) and a 64-column
# tail (N = 2880), K = 2880 (45 groups of 64) and 11008 (86 int4 stages,
# split-K at small M), g = 64, 128, 256 and per-channel g = K = 2880
# (a stage straddles its end), layer 3 of a 4-plane stack.
TC_SHAPES = [(17, 2880, 136, 64), (40, 11008, 1000, 256),
             (64, 4096, 2880, 128), (65, 2880, 1000, 64),
             (128, 11008, 4096, 64), (129, 512, 2880, 256),
             (256, 4096, 136, 128), (257, 2880, 2880, 64),
             (1000, 4096, 2880, 64), (40, 2880, 2880, 2880)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", [(4, False), (4, True), (8, False),
                                       (8, True)],
                         ids=["int4", "int4_zp", "int8", "int8_zp"])
@pytest.mark.parametrize("M,K,N,g", TC_SHAPES)
def test_cuda_qmm_tensor_core_edges_match_plain(bits, asym, M, K, N, g):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(M * 7 + K + N + bits)
    qt = _qtensor(gen, (4,), K, N, bits, asym, g)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wrapper = qmm.qmm_int8 if bits == 8 else qmm.qmm_int4
    before = wrapper.launches
    got = wrapper(x, qt, 3).float()
    want = qmm.qmatmul_plain(x, qt, 3).float()
    assert wrapper.launches == before + 1
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", [(4, False), (4, True), (8, False),
                                       (8, True)],
                         ids=["int4", "int4_zp", "int8", "int8_zp"])
@pytest.mark.parametrize("M,K,N", [(128, 11008, 4096), (40, 4096, 2880)])
def test_cuda_qmm_split_k_repeats_its_bits(bits, asym, M, K, N):
    """Split-K partials are summed in a fixed order (no atomics), so two
    calls give the same bits, as greedy decoding needs."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    assert _build.library().ti_qmm_workspace(M, K, N, bits) > 0   # split
    gen = torch.Generator(device="cuda").manual_seed(K + bits)
    qt = _qtensor(gen, (2,), K, N, bits, asym)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wrapper = qmm.qmm_int8 if bits == 8 else qmm.qmm_int4
    first = wrapper(x, qt, 1)
    assert torch.equal(first, wrapper(x, qt, 1))
    want = qmm.qmatmul_plain(x, qt, 1).float()
    assert (first.float() - want).abs().max().item() <= \
        2e-2 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", [(8, False), (8, True), (4, True)],
                         ids=["int8", "int8_zp", "int4_zp"])
@pytest.mark.parametrize("G,M,K,N,slots", [
    (2, 1, 512, 2880, [5, 0]), (3, 1, 2880, 136, [11, 11, 0]),
    (4, 3, 256, 256, [2, 9, 2, 7]), (2, 16, 128, 64, [-3, 99])])
def test_cuda_qmm_grouped_int8_and_zero_points_match_plain(bits, asym, G, M,
                                                           K, N, slots):
    """The grouped kernel over int8 and zero-point stacks: repeated slots,
    clamped ids, K=2880, a 64-column tail."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(G * M + K + bits)
    qt = _qtensor(gen, (12,), K, N, bits, asym)
    x = torch.randn((G, M, K), generator=gen, device="cuda").to(torch.bfloat16)
    s = torch.tensor(slots, dtype=torch.int32, device="cuda")
    wrapper = qmm.qmm_int8_grouped if bits == 8 else qmm.qmm_int4_grouped
    got = wrapper(x, qt, s).float()
    want = qmm.qmatmul_grouped_plain(x, qt, s).float()
    assert got.shape == (G, M, N)
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_qmm_refuses_mismatched_weights():
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    gen = torch.Generator(device="cuda").manual_seed(4)
    q8 = _qtensor(gen, (2,), 128, 64, 8, True)
    q4 = _qtensor(gen, (2,), 128, 64, 4, False)
    x = torch.randn((3, 128), device="cuda").to(torch.bfloat16)
    for fn, qt in ((qmm.qmm_int4, q8), (qmm.qmm_int8, q4)):
        with pytest.raises(KernelError):      # the other width
            fn(x, qt, 0)
    bad = QTensor(data=q8.data, scales=q8.scales,
                  zero_points=q8.zero_points.float(), bits=8, group_size=64,
                  shape=(128, 64))
    with pytest.raises(KernelError):          # f32 zero points
        qmm.qmm_int8(x, bad, 0)
    odd = _qtensor(gen, (1,), 128, 60, 8, False)
    with pytest.raises(KernelError):          # N % 8 != 0
        qmm.qmm_int8(x, odd, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 4), (64, 8, 2), (128, 2, 1),
                                      (128, 32, 8), (256, 2, 1), (256, 16, 8),
                                      (96, 32, 32), (96, 32, 8)])
def test_cuda_attention_kernels_match_plain(D, Hq, Hkv):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D)

    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    B, S, T = 2, 80, 96
    q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_len = torch.tensor([80, 33], dtype=torch.int32, device="cuda")
    q0 = torch.zeros((B,), dtype=torch.int32, device="cuda")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention.flash_prefill(q, kt, vt, kv_len, q0).float()
    want = flash_attention.prefill_plain(q, kt, vt, kv_len, q0).float()
    # bf16 probabilities in P V; outputs may round one bf16 ulp apart
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2.0 ** -7)
    kc = torch.zeros((2, B, Hkv, T, D), dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    kc2, vc2 = kc.clone(), vc.clone()
    cache_write.cache_write_fresh(kc, vc, k, v, 1)
    cache_write.cache_write_plain(kc2, vc2, k, v, 1)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    lens = torch.tensor([0, 80], dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q[:, 0], kc, vc, lens, 1).float()
    want = decode_attention.decode_plain(q[:, 0], kc, vc, lens, 1).float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("window,lens", [
    (None, [1, 255, 256, 257]), (128, [1, 255, 384, 1128]),
    (1, [1, 256, 257, 2048]), (3000, [1, 255, 256, 2048])])
@pytest.mark.parametrize("sinks", [True, False], ids=["sinks", "nosinks"])
def test_cuda_decode_window_sinks_match_plain(window, lens, sinks):
    """GPT-OSS's decode shape (Hq=64, Hkv=8, D=64, T=2048) with a window
    and per-head sinks: the 256-row slices around kv_len 256, a window
    start on a slice boundary (384 - 128), window 1 and a window past
    kv_len; the sink enters the merge once, however many slices run."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(len(lens) + sinks)
    L, B, Hq, Hkv, T, D = 2, 4, 64, 8, 2048, 64
    kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    snk = (2 * torch.randn((Hq,), generator=gen, device="cuda")
           ).to(torch.bfloat16).float() if sinks else None
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q, kc, vc, kv_len, 1, window,
                                            snk).float()
    want = decode_attention.decode_plain(q, kc, vc, kv_len, 1, window,
                                         snk).float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_cuda_decode_refuses_sinks_not_f32():
    """The kernel reads f32 sink logits as given: bf16 or strided sinks
    raise (dispatch.prepare_params casts a model's sinks once)."""
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    kc = torch.zeros((1, 1, 8, 64, 64), dtype=torch.bfloat16, device="cuda")
    q = torch.zeros((1, 64, 64), dtype=torch.bfloat16, device="cuda")
    kv_len = torch.tensor([5], dtype=torch.int32, device="cuda")
    for bad in (torch.zeros(64, dtype=torch.bfloat16, device="cuda"),
                torch.zeros((64, 2), device="cuda")[:, 0]):
        with pytest.raises(KernelError):
            decode_attention.decode_attention(q, kc, kc, kv_len, 0, 8, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 4), (64, 8, 2), (128, 2, 1),
                                      (256, 4, 2), (96, 32, 32)])
def test_cuda_flash_prefill_stacked_chunk_matches_plain(D, Hq, Hkv):
    """A chunked-prefill read: layer li of the stacked [L, B, Hkv, T, D]
    cache, queries at q_start > 0, keys masked at kv_len < T."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + 1)
    L, B, S, T = 3, 3, 24, 160
    kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    q = torch.randn((B, S, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    q_start = torch.tensor([40, 0, 97], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([64, 11, 121], dtype=torch.int32, device="cuda")
    got = flash_attention.flash_prefill(q, kc[1], vc[1], kv_len,
                                        q_start).float()
    want = flash_attention.prefill_plain(q, kc[1], vc[1], kv_len,
                                         q_start).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Hq,Hkv,page,G", [(128, 32, 32, 256, 1),
                                             (128, 32, 8, 256, 1),
                                             (128, 8, 8, 256, 5),
                                             (64, 8, 2, 16, 3),
                                             (32, 4, 4, 8, 2),
                                             (64, 16, 2, 8, 16),
                                             (256, 16, 8, 256, 1),
                                             (256, 16, 8, 256, 5),
                                             (256, 16, 16, 16, 5),
                                             (96, 32, 32, 256, 1),
                                             (96, 32, 32, 256, 5),
                                             (96, 32, 8, 16, 5)])
def test_cuda_paged_attention_matches_plain(D, Hq, Hkv, page, G):
    """Layer 1 of a stacked pool through a shuffled table with shared
    pages and -1 past each row's need; rows whose query sees no key
    (kv_len < G) are undefined and left out."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + G)
    L, P, B, max_pages = 2, 40, 3, 8
    lens = [0, 3 * page + 5, max_pages * page]
    kp = torch.randn((L, P, Hkv, page, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vp = torch.randn((L, P, Hkv, page, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    q = torch.randn((B, G, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    table = torch.randint(0, P, (B, max_pages), generator=gen,
                          device="cuda", dtype=torch.int32)
    for b, n in enumerate(lens):
        table[b, -(-max(n, 1) // page):] = -1
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = paged_attention.paged_attention(q, kp, vp, table, kv_len, 1)
    want = paged_attention.paged_plain(q, kp, vp, table, kv_len, 1, G)
    qpos = kv_len.clamp(min=1)[:, None] - G + torch.arange(G, device="cuda")
    valid = qpos >= 0
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_unsupported_shapes():
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    kp = torch.zeros((1, 4, 2, 12, 64), dtype=torch.bfloat16, device="cuda")
    q = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16, device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    kv = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(KernelError):          # page 12 is not a multiple of 8
        paged_attention.paged_attention(q, kp, kp, table, kv, 0)
    with pytest.raises(KernelError):          # G = 17 > 16
        paged_attention.paged_attention(
            torch.zeros((1, 17, 2, 64), dtype=torch.bfloat16, device="cuda"),
            kp[:, :, :, :8].contiguous(), kp[:, :, :, :8].contiguous(),
            table, kv, 0)
    with pytest.raises(KernelError):          # f32 is not taken
        paged_attention.paged_attention(q.float(), kp.float(), kp.float(),
                                        table, kv, 0)


# -- int8 and fp8 caches --------------------------------------------------

KINDS = {"int8": torch.int8, "fp8": torch.uint8}


def _compressed(gen, shape, kind):
    """Random bf16 K/V encoded to `kind` by the plain codec -> (storage,
    scale planes or None)."""
    from turboinfer_tpu_torch.models.common import encode_kv_scaled
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return encode_kv_scaled(x, KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("D,Hkv,layout", [(128, 32, "decode"),
                                          (128, 8, "prefill"),
                                          (64, 8, "paged"),
                                          (32, 4, "prefill"),
                                          (256, 8, "decode"),
                                          (256, 8, "prefill"),
                                          (256, 8, "paged"),
                                          (96, 32, "decode"),
                                          (96, 32, "prefill"),
                                          (96, 8, "paged")])
def test_cuda_kv_encode_write_is_byte_exact(kind, D, Hkv, layout):
    """The encode-and-write kernel against encode_kv_scaled plus an
    indexed assignment, byte for byte, at the three addressings: a
    decode step (row ((li B + b) Hkv) T + pos), a prefill slab with
    skipped rows (-1) and strided K/V views, and pages. fp8 inputs cross
    +-464 and hold inf/NaN."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + Hkv)
    L, B, T, P, page = 3, 4, 64, 9, 16
    if layout == "paged":
        shape, W = (L, P, Hkv, page, D), page
        S = 5
        # distinct (page, offset) slots: two tokens never share a row
        slot = torch.randperm(P * page, generator=gen, device="cuda")[:B * S]
        rows = (slot // page) * (Hkv * page) + slot % page
    else:
        shape, W = (L, B, Hkv, T, D), T
        S = 1 if layout == "decode" else 24
        start = torch.tensor([0, 7, 50, 63], device="cuda")[:, None]
        pos = start + torch.arange(S, device="cuda")[None, :]
        rows = torch.arange(B, device="cuda")[:, None] * (Hkv * T) + pos
        rows = torch.where(pos < T, rows, -1).reshape(-1)
    qkv = 300 * torch.randn((B * S, 3 * Hkv * D), generator=gen,
                            device="cuda")
    if kind == "fp8":
        qkv[0, :4] = torch.tensor([464.0, -465.0, float("inf"), float("nan")])
    qkv = qkv.to(torch.bfloat16)
    k = qkv[:, Hkv * D: 2 * Hkv * D].reshape(B * S, Hkv, D)
    v = qkv[:, 2 * Hkv * D:].reshape(B * S, Hkv, D)
    dt = KINDS[kind]
    kc = torch.randint(-100, 100, shape, generator=gen, device="cuda").to(dt)
    vc = kc.clone()
    ks = vs = None
    if kind == "int8":
        ks = torch.rand(shape[:-1], generator=gen, device="cuda")
        vs = ks.clone()
    ref = [t.clone() if t is not None else None for t in (kc, vc, ks, vs)]
    before = cache_write.kv_encode_write.launches
    cache_write.kv_encode_write(k, v, kc, vc, ks, vs, rows, 1 * shape[1] * Hkv * W, W)
    cache_write.kv_encode_write_plain(k, v, *ref, rows, 1 * shape[1] * Hkv * W, W)
    torch.cuda.synchronize()
    assert cache_write.kv_encode_write.launches == before + 1
    assert torch.equal(kc, ref[0]) and torch.equal(vc, ref[1])
    if kind == "int8":
        assert torch.equal(ks.view(torch.int32), ref[2].view(torch.int32))
        assert torch.equal(vs.view(torch.int32), ref[3].view(torch.int32))


# Row absmax values whose int8 rows sit on rounding ties: at 127 the
# scale is exactly 1.0 and at 63.5 exactly 0.5, so every bf16 value with
# a .5 (or .25) fraction divides to a half-integer; the others put many
# quotients within 2^-13 of one; 3e-13 is under the 1e-12 scale floor,
# 2^-130 a subnormal, 1.5e38 near the top of the range.
TIE_ABSMAX = (127.0, 63.5, 1.0, 448.0, 100.5, 3e-13, 2.0 ** -130, 1.5e38)


def _tie_rows(D):
    """bf16 rows [R, D] as f32: for each absmax a of TIE_ABSMAX, every
    bf16 value of magnitude <= a, both signs, D - 1 a row beside a."""
    import numpy as np
    out = []
    for a in TIE_ABSMAX:
        a16 = int(np.float32(a).view(np.uint32)) >> 16
        mags = (np.arange(a16 + 1, dtype=np.uint32) << 16).view(np.float32)
        vals = np.concatenate([mags, -mags[1:]])
        vals = np.concatenate([vals, np.zeros((-len(vals)) % (D - 1),
                                              np.float32)])
        vals = vals.reshape(-1, D - 1)
        out.append(np.concatenate([np.full((len(vals), 1), mags[-1]), vals],
                                  axis=1))
    return torch.from_numpy(np.concatenate(out))


def _encode_rows_both_ways(x, kind, Hkv=2):
    """x [R, D] bf16 rows (R even) through kv_encode_write and its plain
    version into a [1, 1, Hkv, R / Hkv, D] cache, as K and, reversed, as
    V -> (kernel tensors, plain tensors): caches, then scale planes."""
    R, D = x.shape
    N = R // Hkv
    k = x.reshape(N, Hkv, D)
    v = x.flip(0).reshape(N, Hkv, D)
    shape = (1, 1, Hkv, N, D)
    kc = torch.zeros(shape, dtype=KINDS[kind], device="cuda")
    vc = torch.zeros_like(kc)
    ks = vs = None
    if kind == "int8":
        ks = torch.zeros(shape[:-1], device="cuda")
        vs = torch.zeros_like(ks)
    ref = [t.clone() if t is not None else None for t in (kc, vc, ks, vs)]
    rows = torch.arange(N, device="cuda")
    cache_write.kv_encode_write(k, v, kc, vc, ks, vs, rows, 0, N)
    cache_write.kv_encode_write_plain(k, v, *ref, rows, 0, N)
    torch.cuda.synchronize()
    return [kc, vc, ks, vs], ref


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_cuda_kv_encode_write_fp8_every_bf16_pattern(D):
    """All 65536 bf16 bit patterns (subnormals, +-448..464 and past it,
    inf and NaN of both signs) through the hardware e4m3 conversion and
    the NaN-code mask, byte for byte with the plain encode (zeros pad the
    last rows where 2 D does not divide 65536)."""
    _need_cuda()
    bits = torch.arange(-32768, 32768, dtype=torch.int16)
    bits = torch.cat([bits, bits.new_zeros((-len(bits)) % (2 * D))])
    x = bits.view(torch.bfloat16).reshape(-1, D).cuda()
    got, want = _encode_rows_both_ways(x, "fp8")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    codes = got[0].flatten()
    assert int(((codes == 0x7F) | (codes == 0xFF)).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_cuda_kv_encode_write_int8_tie_rows(D):
    """int8 rows built on rounding ties (_tie_rows): the codes, taken from
    x * (1 / scale) with a division only near a .5 tie, equal the plain
    encode's round-half-even of the IEEE quotient byte for byte, and the
    scales bit for bit."""
    _need_cuda()
    x = _tie_rows(D)
    x = torch.cat([x, x[: len(x) % 2]]).to(torch.bfloat16).cuda()
    got, want = _encode_rows_both_ways(x, "int8")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_cuda_kv_encode_write_nonfinite_rows(kind):
    """Rows holding inf, -inf or NaN beside finite values (an int8 row's
    scale turns inf or NaN, and its codes come from the division path)
    and all-zero rows (the 1e-12 scale floor), byte for byte and scales
    bit for bit with the plain encode."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = 3 * torch.randn((64, 128), generator=gen, device="cuda")
    x[0, 5], x[1, 0], x[2, 127] = float("inf"), float("-inf"), float("nan")
    x[3, 9], x[3, 10] = float("inf"), float("nan")
    x[4:6] = 0.0
    got, want = _encode_rows_both_ways(x.to(torch.bfloat16), kind)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        if g is not None:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_cuda_kv_encode_write_refuses_misaligned_rows():
    """The kernel reads K/V rows as 16-byte vectors: a view starting one
    element in, or with a head stride off a multiple of 8 elements,
    raises rather than taking a slower path."""
    from turboinfer_tpu_torch.utils.errors import KernelError
    _need_cuda()
    N, Hkv, D = 4, 2, 64
    kc = torch.zeros((1, 1, Hkv, 8, D), dtype=torch.uint8, device="cuda")
    vc = torch.zeros_like(kc)
    rows = torch.arange(N, device="cuda")
    flat = torch.randn((N, Hkv * D + 8), device="cuda").to(torch.bfloat16)
    good = flat[:, : Hkv * D].view(N, Hkv, D)
    shifted = flat[:, 1: 1 + Hkv * D].view(N, Hkv, D)
    wide = torch.randn((N, Hkv, D + 4), device="cuda").to(
        torch.bfloat16)[..., :D]
    cache_write.kv_encode_write(good, good, kc, vc, None, None, rows, 0, 8)
    for bad in (shifted, wide):
        with pytest.raises(KernelError):
            cache_write.kv_encode_write(bad, good, kc, vc, None, None, rows,
                                        0, 8)
        with pytest.raises(KernelError):
            cache_write.kv_encode_write(good, bad, kc, vc, None, None, rows,
                                        0, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("D,Hq,Hkv,window", [(128, 32, 32, None),
                                             (128, 32, 8, None),
                                             (64, 16, 2, 100),
                                             (32, 4, 4, None),
                                             (256, 16, 8, None),
                                             (256, 16, 16, 100),
                                             (96, 32, 32, 2047),
                                             (96, 32, 8, None)])
def test_cuda_decode_compressed_matches_plain(kind, D, Hq, Hkv, window):
    """The decode kernel's int8 (scaled) and fp8 reads of layer 1 against
    decode_plain on the dequantized layer, kv_len across slices."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + Hq)
    L, B, T = 2, 4, 640
    kc, ks = _compressed(gen, (L, B, Hkv, T, D), kind)
    vc, vs = _compressed(gen, (L, B, Hkv, T, D), kind)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kv_len = torch.tensor([1, 255, 257, 640], dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q, kc, vc, kv_len, 1, window,
                                            None, ks, vs).float()
    want = decode_attention.decode_plain(q, kc, vc, kv_len, 1, window, None,
                                         ks, vs).float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 4), (64, 8, 2), (128, 32, 8),
                                      (256, 16, 8), (96, 32, 32)])
def test_cuda_flash_prefill_stacked_compressed_matches_plain(kind, D, Hq, Hkv):
    """The stacked read of an int8 (scale planes of layer li) or fp8
    cache at q_start > 0 against prefill_plain on the dequantized layer."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + 3)
    L, B, S, T = 3, 3, 24, 160
    kc, ks = _compressed(gen, (L, B, Hkv, T, D), kind)
    vc, vs = _compressed(gen, (L, B, Hkv, T, D), kind)
    q = torch.randn((B, S, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    q_start = torch.tensor([40, 0, 97], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([64, 11, 121], dtype=torch.int32, device="cuda")
    sc = (None, None) if ks is None else (ks[1], vs[1])
    got = flash_attention.flash_prefill(q, kc[1], vc[1], kv_len, q_start,
                                        *sc).float()
    want = flash_attention.prefill_plain(q, kc[1], vc[1], kv_len, q_start,
                                         *sc).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2.0 ** -7)


GQA_GROUPS = [(4, 4), (4, 2), (8, 2), (16, 2), (6, 2)]   # gh 1, 2, 4, 8, 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("Hq,Hkv", GQA_GROUPS)
def test_cuda_flash_prefill_gqa_stacked_matches_plain(kind, D, Hq, Hkv):
    """The stacked read with a query head group packed into each tile's
    rows (gh = Hq/Hkv 1, 2, 4, 8 and 3): S=200 (not a multiple of a
    tile), q_start > 0 with kv_len < q_start + S (rows past kv_len see
    every key), query tiles straddling kv_len, T=384 (three key tiles);
    a repeated call gives the same bits."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D * Hq + Hkv)
    L, B, S, T = 2, 3, 200, 384
    if kind is None:
        kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        sc = (None, None)
    else:
        kc, ks = _compressed(gen, (L, B, Hkv, T, D), kind)
        vc, vs = _compressed(gen, (L, B, Hkv, T, D), kind)
        sc = (None, None) if ks is None else (ks[1], vs[1])
    q = torch.randn((B, S, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    q_start = torch.tensor([0, 37, 150], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([200, 150, 170], dtype=torch.int32, device="cuda")
    got = flash_attention.flash_prefill(q, kc[1], vc[1], kv_len, q_start, *sc)
    again = flash_attention.flash_prefill(q, kc[1], vc[1], kv_len, q_start,
                                          *sc)
    want = flash_attention.prefill_plain(q, kc[1], vc[1], kv_len, q_start,
                                         *sc)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2.0 ** -7)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("Hq,Hkv", GQA_GROUPS)
@pytest.mark.parametrize("B,S,fill", [(2, 80, [77, 80]), (1, 200, [200]),
                                      (1, 1024, [1000])],
                         ids=["S80", "S200", "B1-S1024"])
def test_cuda_flash_prefill_gqa_fresh_matches_plain(D, Hq, Hkv, B, S, fill):
    """The fresh read (K/V [B, S, Hkv, D] transposed by strides) with GQA
    packing: S=80 fill 77 and S=200 (tiles not filled), and a B=1 shape
    with few blocks (S=1024 fill 1000, the last query tile past kv_len)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + Hq * Hkv + S)

    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_len = torch.tensor(fill, dtype=torch.int32, device="cuda")
    q0 = torch.zeros((B,), dtype=torch.int32, device="cuda")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention.flash_prefill(q, kt, vt, kv_len, q0)
    want = flash_attention.prefill_plain(q, kt, vt, kv_len, q0)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2.0 ** -7)
    assert torch.equal(got, flash_attention.flash_prefill(q, kt, vt, kv_len,
                                                          q0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
def test_cuda_flash_prefill_wide_group(kind):
    """A group wider than a 64-row tile (Hq/Hkv = 96, one kv head): each
    block packs 48 of the heads at one position a warpgroup, D=64."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(96)
    L, B, S, T, Hq, Hkv, D = 2, 2, 40, 160, 96, 1, 64
    if kind is None:
        kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        sc = (None, None)
    else:
        kc, ks = _compressed(gen, (L, B, Hkv, T, D), kind)
        vc, vs = _compressed(gen, (L, B, Hkv, T, D), kind)
        sc = (None, None) if ks is None else (ks[1], vs[1])
    q = torch.randn((B, S, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    q_start = torch.tensor([3, 100], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([43, 120], dtype=torch.int32, device="cuda")
    got = flash_attention.flash_prefill(q, kc[1], vc[1], kv_len, q_start, *sc)
    want = flash_attention.prefill_plain(q, kc[1], vc[1], kv_len, q_start,
                                         *sc)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("D,Hq,Hkv,page,G", [(128, 32, 32, 256, 1),
                                             (128, 32, 8, 256, 5),
                                             (64, 8, 2, 16, 3),
                                             (32, 4, 4, 8, 2),
                                             (256, 16, 8, 256, 1),
                                             (256, 16, 8, 256, 5),
                                             (256, 16, 16, 16, 5),
                                             (96, 32, 32, 256, 1),
                                             (96, 32, 32, 256, 5)])
def test_cuda_paged_compressed_matches_plain(kind, D, Hq, Hkv, page, G):
    """Paged decode (G=1) and verify over int8 pages with scale pages
    (looked up through the same clamped table entry) and fp8 pages."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(D + G + page)
    L, P, B, max_pages = 2, 40, 3, 8
    lens = [0, 3 * page + 5, max_pages * page]
    kp, ks = _compressed(gen, (L, P, Hkv, page, D), kind)
    vp, vs = _compressed(gen, (L, P, Hkv, page, D), kind)
    q = torch.randn((B, G, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    table = torch.randint(0, P, (B, max_pages), generator=gen,
                          device="cuda", dtype=torch.int32)
    for b, n in enumerate(lens):
        table[b, -(-max(n, 1) // page):] = -1
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = paged_attention.paged_attention(q, kp, vp, table, kv_len, 1, ks, vs)
    want = paged_attention.paged_plain(q, kp, vp, table, kv_len, 1, G, ks, vs)
    qpos = kv_len.clamp(min=1)[:, None] - G + torch.arange(G, device="cuda")
    valid = qpos >= 0
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["decode", "prefill", "paged"])
def test_cuda_fp8_reads_decode_every_code(path):
    """All 256 e4m3 codes, 0x7F/0xFF included (+-480, as the JAX package's
    e4m3_to_bf16 reads them), come out of the fp8 reads exactly: each
    query sees one key, so its output is that key's value row, and every
    e4m3 value is a bf16 value."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import ops
    B, H, D = 8, 1, 32
    codes = torch.arange(256, device="cuda").to(torch.uint8).reshape(B, H, D)
    want = ops.e4m3_to_float(codes).to(torch.bfloat16)
    one = torch.ones((B,), dtype=torch.int32, device="cuda")
    q = torch.zeros((B, 1, H, D), dtype=torch.bfloat16, device="cuda")
    if path == "paged":
        pool = torch.zeros((1, B + 1, H, 8, D), dtype=torch.uint8,
                           device="cuda")
        pool[0, 1:, :, 0] = codes                # row 0 of pages 1..B
        table = torch.arange(1, B + 1, dtype=torch.int32,
                             device="cuda")[:, None]
        got = paged_attention.paged_attention(q, pool, pool, table, one,
                                              0)[:, 0]
    else:
        cache = torch.zeros((1, B, H, 16, D), dtype=torch.uint8,
                            device="cuda")
        cache[0, :, :, 0] = codes
        if path == "decode":
            got = decode_attention.decode_attention(q[:, 0], cache, cache,
                                                    one, 0)
        else:
            got = flash_attention.flash_prefill(q, cache[0], cache[0], one,
                                                torch.zeros_like(one))[:, 0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_compressed_reads_refuse_mismatched_scales():
    """An int8 cache without its scales, an fp8 cache with scales, and a
    non-bf16 write all raise (no fallback to a dequantized copy)."""
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    gen = torch.Generator(device="cuda").manual_seed(0)
    kc, ks = _compressed(gen, (1, 2, 2, 64, 64), "int8")
    fc, _ = _compressed(gen, (1, 2, 2, 64, 64), "fp8")
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device="cuda")
    kv = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    with pytest.raises(KernelError):
        decode_attention.decode_attention(q, kc, kc, kv, 0)
    with pytest.raises(KernelError):
        decode_attention.decode_attention(q, fc, fc, kv, 0, None, None, ks, ks)
    with pytest.raises(KernelError):
        flash_attention.flash_prefill(q[:, None], kc[0], kc[0], kv, kv)
    with pytest.raises(KernelError):
        paged_attention.paged_attention(q[:, None], kc, kc, kv[:, None].int(),
                                        kv, 0)
    rows = torch.zeros((2,), dtype=torch.int64, device="cuda")
    with pytest.raises(KernelError):
        cache_write.kv_encode_write(q[:, :2].float(), q[:, :2].float(), fc, fc,
                                    None, None, rows, 0, 64)


# -- W4A8 (csrc/qmm_a8.cu) and GPT-OSS's 8-bit decode --------------------------

def _a8_rows(gen, M, K):
    """bf16 rows with a zero row and values that sit on .5 ties after the
    division by the row scale."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    x[min(3, M - 1)] = 0
    xf = x.float()
    sx = xf.abs().amax(-1).clamp_min(1e-8) * (1.0 / 127.0)
    ties = (torch.arange(M, device="cuda") % 50 + 0.5) * sx
    x[:, 1] = ties.to(torch.bfloat16)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(1, 8), (9, 4096), (40, 11008), (300, 2880),
                                 (4096, 4096), (4096, 11008), (16, 4104),
                                 (9, 40000)])
def test_cuda_a8_quantize_rows_is_byte_exact(M, K):
    """The row quantizer's codes and f32 row scales, bit for bit: 256 and
    512 threads a row (K below and above 8192), 8-value chunks (K % 16 ==
    8, K = 8) and a row of 80 KB in shared memory (K = 40000)."""
    _need_cuda()
    x = _a8_rows(torch.Generator(device="cuda").manual_seed(M + K), M, K)
    before = qmm.a8_quantize_rows.launches
    xq, sx = qmm.a8_quantize_rows(x)
    want_q, want_s = qmm.a8_quantize_rows_plain(x)
    assert qmm.a8_quantize_rows.launches == before + 1
    assert torch.equal(xq, want_q)
    assert torch.equal(sx.view(torch.int32), want_s.view(torch.int32))


@pytest.mark.cuda
def test_cuda_a8_quantize_rows_refuses_rows_past_shared_memory():
    """A row lives in shared memory: K past the kernel's 112 * 1024 values
    raises, as K % 8 != 0 does."""
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    for K in (112 * 1024 + 8, 12):
        x = torch.zeros((1, K), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(KernelError):
            qmm.a8_quantize_rows(x)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g", [
    (9, 256, 128, 256), (16, 4096, 12288, 256), (40, 1024, 264, 256),
    (130, 512, 136, 64), (300, 2048, 512, 512), (17, 11008, 256, 256),
    (16, 11008, 4096, 256), (40, 11008, 4096, 256), (64, 512, 256, 256),
    (65, 512, 256, 256), (256, 4096, 4096, 256), (4096, 4096, 512, 256),
    (4096, 11008, 1024, 256), (16, 512, 208, 256), (33, 1024, 4104, 256),
    (9, 256, 136, 64), (40, 1024, 256, 512), (300, 1024, 256, 128),
    (1, 512, 256, 256), (100, 1536, 320, 768)])
def test_cuda_qmm_int4_a8_matches_plain(M, K, N, g):
    """The W4A8 kernel against qmatmul_a8_plain on layer 1 of a stack,
    bit for bit: the group partials are exact integers on both sides and
    every later step is one IEEE rounding in the same order. Token tiles
    16-64 (mma.sync) and 128 (wgmma) on both sides of the boundary (64,
    65), 2 and 4 warpgroups splitting a tile's groups (N = 4096 at M = 16
    and 40), one and two column warpgroups at M = 4096, K=11008 (43
    groups, an odd stage count), N tails inside a column tile (208) and
    rows TMA cannot describe (N % 16 == 8: 264, 136, 4104), g from 64 to
    768 (one unit a stage below 256, the u - 8 form above)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(M * K + N)
    qt = _qtensor(gen, (2,), K, N, 4, False, g)
    x = _a8_rows(gen, M, K)
    before = (qmm.qmm_int4_a8.launches, qmm.a8_quantize_rows.launches)
    got = qmm.qmm_int4_a8(x, qt, 1)
    want = qmm.qmatmul_a8_plain(x, qt, 1)
    assert (qmm.qmm_int4_a8.launches, qmm.a8_quantize_rows.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
def test_cuda_qmm_int4_a8_repeats_its_bits():
    """Calls of mixed shapes in one stream (split warpgroups, mma.sync
    and wgmma tiles) give the same bits each time they repeat."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = []
    for M, K, N in ((16, 11008, 4096), (40, 4096, 4096), (16, 4096, 12288),
                    (256, 4096, 4096), (4096, 4096, 512)):
        cases.append((_a8_rows(gen, M, K), _qtensor(gen, (2,), K, N, 4, False,
                                                    256)))
    first = [qmm.qmm_int4_a8(x, qt, 1) for x, qt in cases]
    for _ in range(2):
        again = [qmm.qmm_int4_a8(x, qt, 1) for x, qt in cases]
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_dispatch_routes_w4a8(monkeypatch):
    """dispatch.qmatmul takes qmm_int4_a8 exactly where a8_applies holds
    (TURBOINFER_QMM_A8=1, M > 8, g=256, a plane of >= 262144 bytes) and
    qmm_int4 elsewhere; qmm_int4_a8 refuses zero points."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import dispatch
    from turboinfer_tpu_torch.utils.errors import KernelError
    gen = torch.Generator(device="cuda").manual_seed(7)
    qt = _qtensor(gen, (2,), 1024, 512, 4, False, 256)     # 256 KiB planes
    x = torch.randn((2, 9, 1024), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def routed(xx):
        b = (qmm.qmm_int4.launches, qmm.qmm_int4_a8.launches)
        dispatch.qmatmul(xx, qt, 1)
        return (qmm.qmm_int4.launches - b[0], qmm.qmm_int4_a8.launches - b[1])
    monkeypatch.delenv("TURBOINFER_QMM_A8", raising=False)
    assert routed(x) == (1, 0)
    monkeypatch.setenv("TURBOINFER_QMM_A8", "1")
    assert routed(x) == (0, 1)
    assert routed(x[:1, :8]) == (1, 0)                      # M = 8
    monkeypatch.setenv("TURBOINFER_QMM_MIN_BYTES", str(1 << 20))
    assert routed(x) == (1, 0)
    zp = _qtensor(gen, (2,), 1024, 512, 4, True, 256)
    with pytest.raises(KernelError):
        qmm.qmm_int4_a8(x, zp, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("window,lens", [
    (128, [1, 255, 384, 1128]), (None, [1, 256, 257, 2048]),
    (1, [1, 256, 257, 2048])])
def test_cuda_decode_compressed_window_sinks_match_plain(kind, window, lens):
    """GPT-OSS's 8-bit decode (decode_fused_pallas with int8 scale planes
    or fp8, sinks and a window) at its shape Hq=64, Hkv=8, D=64, T=2048:
    the kernel against decode_plain on layer 1."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(len(lens) + len(kind))
    L, B, Hq, Hkv, T, D = 2, 4, 64, 8, 2048, 64
    kc, ks = _compressed(gen, (L, B, Hkv, T, D), kind)
    vc, vs = _compressed(gen, (L, B, Hkv, T, D), kind)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    snk = (2 * torch.randn((Hq,), generator=gen, device="cuda")
           ).to(torch.bfloat16).float()
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q, kc, vc, kv_len, 1, window,
                                            snk, ks, vs).float()
    want = decode_attention.decode_plain(q, kc, vc, kv_len, 1, window, snk,
                                         ks, vs).float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2.0 ** -7)


# The decode kernels' slices (csrc/decode_attention.cu plan_of): gh 1 (the
# CUDA-core kernel, 64-row slices) and 2, 4, 8 and 3 (the tensor-core
# kernel, 128-row slices); one sequence and 16; kv_len 1, T and across
# slice edges; windows below a slice, straddling slice edges and past
# kv_len; sinks on every other window.
DECODE_GROUPS = [(4, 4), (4, 2), (8, 2), (16, 2), (6, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("Hq,Hkv", DECODE_GROUPS)
@pytest.mark.parametrize("B", [1, 16])
def test_cuda_decode_slices_match_plain(kind, D, Hq, Hkv, B):
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(D * Hq + B)
    L, T = 2, 320
    if kind is None:
        kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        ks = vs = None
    else:
        kc, ks = _compressed(gen, (L, B, Hkv, T, D), kind)
        vc, vs = _compressed(gen, (L, B, Hkv, T, D), kind)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    snk = (2 * torch.randn((Hq,), generator=gen, device="cuda")
           ).to(torch.bfloat16).float()
    lens = ([[1], [33], [T]] if B == 1 else
            [[1, T, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 200, 255,
              256, 319]])
    for i, (window, ln) in enumerate(
            (w, ln) for w in (None, 7, 40, 1000) for ln in lens):
        kv_len = torch.tensor(ln, dtype=torch.int32, device="cuda")
        sinks = snk if i % 2 else None
        got = decode_attention.decode_attention(q, kc, vc, kv_len, 1, window,
                                                sinks, ks, vs)
        want = decode_attention.decode_plain(q, kc, vc, kv_len, 1, window,
                                             sinks, ks, vs)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=2.0 ** -7)
        assert torch.equal(got, decode_attention.decode_attention(
            q, kc, vc, kv_len, 1, window, sinks, ks, vs))
    torch.cuda.synchronize()
    assert not _build.counters(q.device, B * Hkv)[:B * Hkv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(16, 2), (2, 2)], ids=["gqa", "lone"])
@pytest.mark.parametrize("D", [64, 96, 256])
def test_cuda_decode_long_context_matches_plain(kind, Hq, Hkv, D):
    """T = 40000: 313 sub-slices of 128 rows (a GQA group; 625 of 64 at
    D = 256) or 625 of 64 (a lone head), past the 64 slices a kv head
    takes, so each block reads 5 or 10 sub-slices in turn and the last
    block merges 63 slices in two chunks of 32; kv_len T, mid-slice, 1
    and in the second slice; a window of 19200 rows; sinks; repeat calls
    bit-identical. One sub-slice (a window of 64 rows) needs no
    scratch."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(Hq + (D - 64) + 40000)
    L, B, T = 1, 4, 40000
    shape = (L, B, Hkv, T, D)
    if kind is None:
        kc = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        ks = vs = None
    else:
        kc, ks = _compressed(gen, shape, kind)
        vc, vs = _compressed(gen, shape, kind)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    snk = (2 * torch.randn((Hq,), generator=gen, device="cuda")
           ).to(torch.bfloat16).float()
    kv_len = torch.tensor([T, 33333, 1, 1000], dtype=torch.int32,
                          device="cuda")
    for window, sinks in ((None, snk), (None, None), (19200, snk)):
        got = decode_attention.decode_attention(q, kc, vc, kv_len, 0, window,
                                                sinks, ks, vs)
        want = decode_attention.decode_plain(q, kc, vc, kv_len, 0, window,
                                             sinks, ks, vs)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=2.0 ** -7)
        assert torch.equal(got, decode_attention.decode_attention(
            q, kc, vc, kv_len, 0, window, sinks, ks, vs))
    lib = _build.library()
    assert lib.ti_decode_workspace(B, Hq, Hkv, T, D, 64) == 0
    assert lib.ti_decode_workspace(B, Hq, Hkv, T, D, 0) == B * Hq * 63 * (D + 2)
    torch.cuda.synchronize()
    assert not _build.counters(q.device, B * Hkv)[:B * Hkv].any()


QMM_KINDS = [(4, False), (4, True), (8, False), (8, True)]
QMM_IDS = ["int4", "int4_zp", "int8", "int8_zp"]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", QMM_KINDS, ids=QMM_IDS)
@pytest.mark.parametrize("M", range(1, 17))
def test_cuda_qmm_gemv_every_m_matches_plain(bits, asym, M):
    """The GEMV at every M of its range (one and two token tiles), N =
    2880 (a 64-column strip tail), g = 64, 128 and 256; a repeat call
    gives the same bits."""
    _need_cuda()
    g = (64, 128, 256)[M % 3]
    K, N = 1536, 2880
    gen = torch.Generator(device="cuda").manual_seed(M * 3 + bits + asym)
    qt = _qtensor(gen, (2,), K, N, bits, asym, g)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wrapper = qmm.qmm_int8 if bits == 8 else qmm.qmm_int4
    got = wrapper(x, qt, 1)
    want = qmm.qmatmul_plain(x, qt, 1).float()
    assert (got.float() - want).abs().max().item() <= \
        2e-2 * want.abs().max().item()
    assert torch.equal(got, wrapper(x, qt, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", QMM_KINDS, ids=QMM_IDS)
@pytest.mark.parametrize("M,K,N,g", [(8, 11008, 4096, 64),
                                     (1, 11008, 136, 128),
                                     (16, 4096, 1000, 256),
                                     (3, 2880, 2880, 64)])
def test_cuda_qmm_gemv_split_k_repeats_its_bits(bits, asym, M, K, N, g):
    """Split K (K = 11008: 172 steps), 8-byte weight rows (N = 136,
    1000), and the last block's fixed-order sum: back-to-back calls on
    one stream give the same bits and leave the counters zeroed."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(K + N + bits + asym)
    qt = _qtensor(gen, (2,), K, N, bits, asym, g)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wrapper = qmm.qmm_int8 if bits == 8 else qmm.qmm_int4
    outs = [wrapper(x, qt, 1) for _ in range(3)]
    want = qmm.qmatmul_plain(x, qt, 1).float()
    assert (outs[0].float() - want).abs().max().item() <= \
        2e-2 * want.abs().max().item()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    torch.cuda.synchronize()
    n = _build.library().ti_qmm_counters(N)
    assert not _build.counters(x.device, n)[:n].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", QMM_KINDS, ids=QMM_IDS)
def test_cuda_qmm_grouped_split_k_repeats_its_bits(bits, asym):
    """The grouped GEMV with split K over 8 planes: clamped slots (-1,
    100), two rows a group, repeat calls bit-identical."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(11 + bits + asym)
    K, N, G, M = 11008, 1024, 3, 2
    qt = _qtensor(gen, (8,), K, N, bits, asym)
    x = torch.randn((G, M, K), generator=gen, device="cuda").to(torch.bfloat16)
    s = torch.tensor([-1, 7, 100], dtype=torch.int32, device="cuda")
    wrapper = qmm.qmm_int8_grouped if bits == 8 else qmm.qmm_int4_grouped
    got = wrapper(x, qt, s)
    want = qmm.qmatmul_grouped_plain(x, qt, s).float()
    assert (got.float() - want).abs().max().item() <= \
        2e-2 * want.abs().max().item()
    assert torch.equal(got, wrapper(x, qt, s))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,asym", QMM_KINDS, ids=QMM_IDS)
@pytest.mark.parametrize("M", [1, 9])
def test_cuda_qmm_grouped_stays_inside_its_scratch(bits, asym, M):
    """Two planes of N = 7168 (56 column blocks each): the launch plans
    its split count over both groups' 112 blocks, more splits than one
    group's 56 would take when the dequantization is heavy (zero points
    or M > 8). The scratch ti_qmm_grouped_workspace sizes holds every
    partial: a guard of NaNs past its end stays untouched, and the
    result matches the plain version."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(13 + bits + asym + M)
    K, N, G = 4096, 7168, 2
    qt = _qtensor(gen, (4,), K, N, bits, asym)
    x = torch.randn((G, M, K), generator=gen, device="cuda").to(torch.bfloat16)
    s = torch.tensor([3, 0], dtype=torch.int32, device="cuda")
    lib = _build.library()
    nws = lib.ti_qmm_grouped_workspace(G, M, K, N, bits)
    assert nws > 0                                       # split K
    ws = torch.full((nws + G * M * N,), float("nan"), device="cuda")
    y = torch.empty((G, M, N), dtype=torch.bfloat16, device="cuda")
    cnt = _build.counters(x.device, G * lib.ti_qmm_counters(N))
    zp = qt.zero_points
    status = lib.ti_qmm_grouped(
        x.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(),
        None if zp is None else zp.data_ptr(), s.data_ptr(), y.data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), G, M, K, N, qt.group_size, bits,
        qt.data.shape[0], torch.cuda.current_stream().cuda_stream)
    assert status == 0
    torch.cuda.synchronize()
    assert torch.isnan(ws[nws:]).all()
    want = qmm.qmatmul_grouped_plain(x, qt, s).float()
    assert (y.float() - want).abs().max().item() <= \
        2e-2 * want.abs().max().item()
    wrapper = qmm.qmm_int8_grouped if bits == 8 else qmm.qmm_int4_grouped
    assert torch.equal(y, wrapper(x, qt, s))


# -- paged attention: every query row of a kv head in one tile ---------------

# (G, Hq, Hkv): R = G * Hq / Hkv query rows a kv head. R = 1 is the
# CUDA-core kernel; 5 (a 7B verify, gh = 1) and 20 (Mixtral's gh = 4 at
# G = 5) one tensor-core row chunk of 8 and 32 rows; 128 (G = 16, gh = 8)
# four chunks of 32 over the same staged keys.
PAGED_ROWS = [(1, 4, 4), (5, 4, 4), (5, 8, 2), (16, 8, 1)]
PAGED_ROW_IDS = ["R1", "R5", "R20", "R128"]


def _paged_pools(gen, shape, kind):
    """bf16 K/V pools, or int8 (with scale pages) / fp8 by the plain codec
    -> (k, v, k_scale, v_scale)."""
    if kind is None:
        k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        return k, v, None, None
    (k, ks), (v, vs) = _compressed(gen, shape, kind), _compressed(gen, shape,
                                                                  kind)
    return k, v, ks, vs


def _paged_check(q, kp, vp, table, kv_len, li, ks, vs):
    """The kernel against paged_plain on the rows that see a key, and a
    repeat call bit for bit."""
    G = q.shape[1]
    got = paged_attention.paged_attention(q, kp, vp, table, kv_len, li, ks, vs)
    want = paged_attention.paged_plain(q, kp, vp, table, kv_len, li, G, ks, vs)
    qpos = kv_len.clamp(min=1)[:, None] - G + torch.arange(G, device="cuda")
    valid = qpos >= 0
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               atol=1e-2, rtol=2.0 ** -7)
    assert torch.equal(got, paged_attention.paged_attention(
        q, kp, vp, table, kv_len, li, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("G,Hq,Hkv", PAGED_ROWS, ids=PAGED_ROW_IDS)
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("page", [8, 16, 256])
def test_cuda_paged_rows_match_plain(kind, G, Hq, Hkv, D, page):
    """Sub-slices of 128 (or 64) keys that cross 8- and 16-token pages,
    kv_len 1, below G, at and across the sub-slice edges and at the
    capacity, through a shuffled table of distinct pages with -1 past each
    row's need; repeat calls bit-identical and the counters left zeroed."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(D * G + Hq + page)
    max_pages = 2 if page == 256 else 320 // page
    cap = max_pages * page
    B, L = 8, 2
    P = B * max_pages + 1
    kp, vp, ks, vs = _paged_pools(gen, (L, P, Hkv, page, D), kind)
    q = torch.randn((B, G, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = [1, 3, 63, 128, 129, 256, 300, cap]
    table = torch.randperm(P, generator=gen, device="cuda")[:B * max_pages]
    table = table.reshape(B, max_pages).int()
    for b, n in enumerate(lens):
        table[b, -(-n // page):] = -1
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    _paged_check(q, kp, vp, table, kv_len, 1, ks, vs)
    torch.cuda.synchronize()
    assert not _build.counters(q.device, B * Hkv)[:B * Hkv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("G,Hq,Hkv", [(1, 2, 2), (5, 8, 2), (16, 16, 2)],
                         ids=["R1", "R20", "R128"])
def test_cuda_paged_long_context_matches_plain(kind, G, Hq, Hkv):
    """A capacity of 157 pages of 256 (40192 rows): 314 sub-slices of 128
    keys (628 of 64 for R = 1), past the 64 slices a kv head takes, so
    each block reads 5 (10) sub-slices in turn; at R = 128 the four row
    chunks keep their running outputs in shared memory between them.
    kv_len at the capacity, mid-slice, 1 and in the second slice. One
    slice covering the capacity needs no scratch."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(G + Hq + 40000)
    B, page, max_pages, D = 4, 256, 157, 64
    P = B * max_pages + 1
    kp, vp, ks, vs = _paged_pools(gen, (1, P, Hkv, page, D), kind)
    q = torch.randn((B, G, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    table = torch.randperm(P, generator=gen, device="cuda")[:B * max_pages]
    table = table.reshape(B, max_pages).int()
    kv_len = torch.tensor([max_pages * page, 33333, 1, 1000],
                          dtype=torch.int32, device="cuda")
    _paged_check(q, kp, vp, table, kv_len, 0, ks, vs)
    R = G * Hq // Hkv
    lib = _build.library()
    assert lib.ti_paged_workspace(B, Hkv, R, max_pages * page, D) == \
        B * Hkv * R * 63 * (D + 2)
    assert lib.ti_paged_workspace(B, Hkv, R, 128 if R > 1 else 64, D) == 0
    assert lib.ti_paged_workspace(B, Hkv, R, 256, D) > 0
    torch.cuda.synchronize()
    assert not _build.counters(q.device, B * Hkv)[:B * Hkv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("G,Hq,Hkv", [(1, 2, 2), (5, 8, 2), (8, 16, 2)],
                         ids=["R1", "R20", "R64"])
def test_cuda_paged_long_context_head_dim_256(kind, G, Hq, Hkv):
    """D = 256 over a capacity of 157 pages of 256 (40192 rows): 628
    sub-slices of 64 keys, 10 a block; at R = 64 the two row chunks keep
    their running outputs in shared memory between sub-slices. R = 128
    would keep 132 KB of them beside the tiles and is refused, not run
    another way."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    from turboinfer_tpu_torch.utils.errors import KernelError
    gen = torch.Generator(device="cuda").manual_seed(G + Hq + 256)
    B, page, max_pages, D = 4, 256, 157, 256
    P = B * max_pages + 1
    kp, vp, ks, vs = _paged_pools(gen, (1, P, Hkv, page, D), kind)
    q = torch.randn((B, G, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    table = torch.randperm(P, generator=gen, device="cuda")[:B * max_pages]
    table = table.reshape(B, max_pages).int()
    kv_len = torch.tensor([max_pages * page, 33333, 1, 1000],
                          dtype=torch.int32, device="cuda")
    _paged_check(q, kp, vp, table, kv_len, 0, ks, vs)
    R = G * Hq // Hkv
    lib = _build.library()
    assert lib.ti_paged_workspace(B, Hkv, R, max_pages * page, D) == \
        B * Hkv * R * 63 * (D + 2)
    assert lib.ti_paged_workspace(B, Hkv, R, 64, D) == 0
    if G == 8:
        wide = torch.zeros((B, 16, Hq, D), dtype=torch.bfloat16,
                           device="cuda")
        with pytest.raises(KernelError):
            paged_attention.paged_attention(wide, kp, vp, table, kv_len, 0,
                                            ks, vs)
    torch.cuda.synchronize()
    assert not _build.counters(q.device, B * Hkv)[:B * Hkv].any()


@pytest.mark.cuda
def test_cuda_paged_counters_stay_zero_at_mixed_shapes():
    """Calls at mixed B and G on one stream, unsynchronised in between:
    each matches its plain form and every arrival counter is 0 after."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(77)
    L, P, Hkv, page, D = 2, 60, 8, 16, 128
    kp, vp, _, _ = _paged_pools(gen, (L, P, Hkv, page, D), None)
    runs = []
    for B, G in ((1, 1), (8, 5), (3, 16), (8, 1), (2, 2)):
        q = torch.randn((B, G, 32, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        table = torch.randint(0, P, (B, 40), generator=gen, device="cuda",
                              dtype=torch.int32)
        kv_len = torch.randint(G, 40 * page + 1, (B,), generator=gen,
                               device="cuda", dtype=torch.int32)
        got = paged_attention.paged_attention(q, kp, vp, table, kv_len, B % 2)
        runs.append((got, q, table, kv_len, B % 2))
    for got, q, table, kv_len, li in runs:
        want = paged_attention.paged_plain(q, kp, vp, table, kv_len, li,
                                           q.shape[1])
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=2.0 ** -7)
    torch.cuda.synchronize()
    assert not _build.counters(q.device, 8 * Hkv)[:8 * Hkv].any()


# -- softcap and sliding windows (Gemma-2, Mistral) ---------------------------

# (window, softcap, query scale): a cap the scores pass by 2-3x (queries
# drawn 4x wider: scores of spread ~4, tails past 10 against cap 4), the
# same cap on a window that is no multiple of the 128-key tiles, Gemma-2's
# cap 50 that plain scores stay below, windows alone, and Gemma-2-27B's
# window less 37 keys
WINDOW_CAPS = {"cap4": (None, 4.0, 4.0), "w600_cap4": (600, 4.0, 4.0),
               "w600_cap50": (600, 50.0, 1.0), "w129": (129, None, 1.0),
               "w13": (13, None, 1.0), "w4059_cap4": (4096 - 37, 4.0, 4.0)}


def _kv_pair(gen, shape, kind):
    """K and V of `kind` (None: bf16) -> (k, v, k_scale, v_scale)."""
    return _paged_pools(gen, shape, kind)


def _qpos_rows(q_start, S, kv_len):
    """[B, S] rows whose position is < kv_len: each sees at least its own
    key, whatever the window (a padded row may see none: undefined)."""
    pos = q_start[:, None] + torch.arange(S, device="cuda")[None, :]
    return pos < kv_len[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(WINDOW_CAPS))
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 32, 16), (64, 8, 2), (32, 4, 4),
                                      (128, 8, 1), (256, 16, 8), (256, 8, 1),
                                      (96, 32, 32), (96, 8, 2)])
def test_cuda_flash_prefill_fresh_window_softcap_matches_plain(mask, D, Hq,
                                                               Hkv):
    """The fresh read with a window and a softcap, S=1100 fill 1100 and
    777 (S=4200 for the 4059-key window): with gh=2 (Gemma-2's 32:16) a
    block holds 64 positions, so at window 600 blocks whose first tile
    (q_first - window + 1) mod 128 > 64 give their later rows a first
    tile with every key masked; a repeated call gives the same bits."""
    _need_cuda()
    window, cap, qs = WINDOW_CAPS[mask]
    gen = torch.Generator(device="cuda").manual_seed(D + Hq + len(mask))
    B, S = 2, 4200 if window and window > 2000 else 1100

    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    q = (qs * rnd(B, S, Hq, D).float()).to(torch.bfloat16)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_len = torch.tensor([S, S - 323], dtype=torch.int32, device="cuda")
    q0 = torch.zeros((B,), dtype=torch.int32, device="cuda")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention.flash_prefill(q, kt, vt, kv_len, q0, window=window,
                                        softcap=cap)
    want = flash_attention.prefill_plain(q, kt, vt, kv_len, q0,
                                         window=window, softcap=cap)
    rows = _qpos_rows(q0, S, kv_len)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               atol=2e-2, rtol=2.0 ** -7)
    assert torch.equal(got, flash_attention.flash_prefill(
        q, kt, vt, kv_len, q0, window=window, softcap=cap))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("mask", ["cap4", "w600_cap4", "w129", "w13"])
@pytest.mark.parametrize("Hq,Hkv", [(32, 16), (6, 2)])
@pytest.mark.parametrize("D", [96, 128, 256])
def test_cuda_flash_prefill_stacked_window_softcap_matches_plain(kind, mask,
                                                                 Hq, Hkv, D):
    """The chunked read of layer 1 of a stacked cache (bf16, int8, fp8)
    at q_start 4096 and 700 with a window and a softcap: the key loop
    starts at the tile of the block's earliest window (128 keys a tile,
    64 at D = 256)."""
    _need_cuda()
    window, cap, qs = WINDOW_CAPS[mask]
    gen = torch.Generator(device="cuda").manual_seed(Hq + (D - 128) +
                                                     len(mask))
    L, B, S, T = 2, 2, 300, 4608
    kc, vc, ks, vs = _kv_pair(gen, (L, B, Hkv, T, D), kind)
    sc = (None, None) if ks is None else (ks[1], vs[1])
    q = (qs * torch.randn((B, S, Hq, D), generator=gen, device="cuda")).to(
        torch.bfloat16)
    q_start = torch.tensor([4096, 700], dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([4396, 911], dtype=torch.int32, device="cuda")
    got = flash_attention.flash_prefill(q, kc[1], vc[1], kv_len, q_start,
                                        *sc, window=window, softcap=cap)
    want = flash_attention.prefill_plain(q, kc[1], vc[1], kv_len, q_start,
                                         *sc, window=window, softcap=cap)
    rows = _qpos_rows(q_start, S, kv_len)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               atol=2e-2, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("mask", list(WINDOW_CAPS))
@pytest.mark.parametrize("Hq,Hkv", [(32, 16), (8, 1), (4, 4)])
@pytest.mark.parametrize("D", [96, 128, 256])
def test_cuda_decode_window_softcap_matches_plain(kind, mask, Hq, Hkv, D):
    """Decode over bf16, int8 and fp8 caches (T=8192) with a softcap on
    the tensor-core GQA kernel (gh 2 and 8) and the lone-head kernel, on
    windowed and global rows: kv_len 1, 4000, 4097 (a window start past
    a slice edge), 8192; a repeated call gives the same bits."""
    _need_cuda()
    window, cap, qs = WINDOW_CAPS[mask]
    gen = torch.Generator(device="cuda").manual_seed(Hq * Hkv + (D - 128) +
                                                     len(mask))
    L, B, T = 2, 4, 8192
    kc, vc, ks, vs = _kv_pair(gen, (L, B, Hkv, T, D), kind)
    q = (qs * torch.randn((B, Hq, D), generator=gen, device="cuda")).to(
        torch.bfloat16)
    kv_len = torch.tensor([1, 4000, 4097, 8192], dtype=torch.int32,
                          device="cuda")
    got = decode_attention.decode_attention(q, kc, vc, kv_len, 1, window,
                                            None, ks, vs, cap)
    want = decode_attention.decode_plain(q, kc, vc, kv_len, 1, window, None,
                                         ks, vs, cap)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2.0 ** -7)
    assert torch.equal(got, decode_attention.decode_attention(
        q, kc, vc, kv_len, 1, window, None, ks, vs, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, *KINDS], ids=["bf16", *KINDS])
@pytest.mark.parametrize("mask", ["cap4", "w600_cap4", "w600_cap50", "w129",
                                  "w13"])
@pytest.mark.parametrize("G,Hq,Hkv,page", [(1, 32, 16, 256), (5, 32, 16, 256),
                                           (1, 4, 4, 16), (5, 8, 1, 16),
                                           (16, 16, 2, 8)],
                         ids=["G1-gh2", "G5-gh2", "G1-gh1", "G5-gh8",
                              "G16-gh8"])
@pytest.mark.parametrize("D", [96, 128, 256])
def test_cuda_paged_window_softcap_matches_plain(kind, mask, G, Hq, Hkv,
                                                 page, D):
    """Paged decode (G=1) and verify (G=5, 16) over bf16, int8 and fp8
    pools with a window and a softcap. The slices count from the earliest
    query's first visible key (kv_len - G + 1 - window), so the first
    slice holds keys the later queries do not see (their max there is
    -1e30 and the merge weighs them 0); kv_len G (every query at its
    own start), a window start mid-page, and full tables; a repeated
    call gives the same bits and the counters end at 0."""
    _need_cuda()
    from turboinfer_tpu_torch.kernels import _build
    window, cap, qs = WINDOW_CAPS[mask]
    gen = torch.Generator(device="cuda").manual_seed(G * Hq + page + (D - 128)
                                                     + len(mask))
    L, P, B, max_pages = 2, 300, 4, 4096 // page
    kp, vp, ks, vs = _kv_pair(gen, (L, P, Hkv, page, D), kind)
    q = (qs * torch.randn((B, G, Hq, D), generator=gen, device="cuda")).to(
        torch.bfloat16)
    table = torch.randint(0, P, (B, max_pages), generator=gen, device="cuda",
                          dtype=torch.int32)
    kv_len = torch.tensor([G, 777, 2000, max_pages * page], dtype=torch.int32,
                          device="cuda")
    got = paged_attention.paged_attention(q, kp, vp, table, kv_len, 1, ks, vs,
                                          window, cap)
    want = paged_attention.paged_plain(q, kp, vp, table, kv_len, 1, G, ks, vs,
                                       window, cap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2.0 ** -7)
    assert torch.equal(got, paged_attention.paged_attention(
        q, kp, vp, table, kv_len, 1, ks, vs, window, cap))
    torch.cuda.synchronize()
    assert not _build.counters(q.device, B * Hkv)[:B * Hkv].any()


@pytest.mark.cuda
def test_cuda_attention_refuses_head_dim_256():
    """D=256 (Gemma-1-7B, Gemma-2-2B/9B, Gemma-3) was refused on the card
    until its kernels were ported: each wrapper now launches its kernel,
    window and softcap included, as the launch counters show."""
    _need_cuda()
    D = 256
    q = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 2, 8, D), dtype=torch.bfloat16, device="cuda")
    kt = kv.transpose(1, 2)                    # [B, S, Hkv, D]
    lens = torch.tensor([8], dtype=torch.int32, device="cuda")
    cache = torch.zeros((1, 1, 2, 16, D), dtype=torch.bfloat16, device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    calls = [
        (flash_attention.flash_prefill,
         lambda: flash_attention.flash_prefill(q, kv, kv, lens, lens * 0,
                                               window=4, softcap=50.0)),
        (decode_attention.decode_attention,
         lambda: decode_attention.decode_attention(q[:, 0], cache, cache,
                                                   lens, 0, softcap=50.0)),
        (paged_attention.paged_attention,
         lambda: paged_attention.paged_attention(q[:, :1], cache[:, :1],
                                                 cache[:, :1], table, lens, 0,
                                                 window=4, softcap=50.0)),
        (cache_write.cache_write_fresh,
         lambda: cache_write.cache_write_fresh(cache, cache.clone(), kt, kt,
                                               0))]
    for wrapper, call in calls:
        before = wrapper.launches
        out = call()
        assert out is None or torch.isfinite(out.float()).all()
        assert wrapper.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_attention_launches_at_head_dim_96():
    """D=96 (Phi-3) was refused on the card until its kernel instances
    were ported: each wrapper now launches its kernel, a window included
    and the encode-and-write beside them, as the launch counters show."""
    _need_cuda()
    D = 96
    q = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 2, 8, D), dtype=torch.bfloat16, device="cuda")
    kt = kv.transpose(1, 2)                    # [B, S, Hkv, D]
    lens = torch.tensor([8], dtype=torch.int32, device="cuda")
    cache = torch.zeros((1, 1, 2, 16, D), dtype=torch.bfloat16, device="cuda")
    codes = torch.zeros((1, 1, 2, 16, D), dtype=torch.uint8, device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    calls = [
        (flash_attention.flash_prefill,
         lambda: flash_attention.flash_prefill(q, kv, kv, lens, lens * 0,
                                               window=4)),
        (decode_attention.decode_attention,
         lambda: decode_attention.decode_attention(q[:, 0], cache, cache,
                                                   lens, 0, window=4)),
        (paged_attention.paged_attention,
         lambda: paged_attention.paged_attention(q[:, :1], cache[:, :1],
                                                 cache[:, :1], table, lens, 0,
                                                 window=4)),
        (cache_write.cache_write_fresh,
         lambda: cache_write.cache_write_fresh(cache, cache.clone(), kt, kt,
                                               0)),
        (cache_write.kv_encode_write,
         lambda: cache_write.kv_encode_write(
             kt[0], kt[0], codes, codes.clone(), None, None,
             torch.arange(8, device="cuda"), 0, 16))]
    for wrapper, call in calls:
        before = wrapper.launches
        out = call()
        assert out is None or torch.isfinite(out.float()).all()
        assert wrapper.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [80, 160])
def test_cuda_head_dim_80_is_refused(D):
    """A head dim with no kernel instance (80: Phi-2, 160) raises on the
    card in each wrapper that takes D, and nothing runs the plain form
    instead: no launch counter moves."""
    _need_cuda()
    from turboinfer_tpu_torch.utils.errors import KernelError
    q = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 2, 8, D), dtype=torch.bfloat16, device="cuda")
    lens = torch.tensor([8], dtype=torch.int32, device="cuda")
    cache = torch.zeros((1, 1, 2, 16, D), dtype=torch.bfloat16, device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    counted = (flash_attention.flash_prefill,
               decode_attention.decode_attention,
               paged_attention.paged_attention, cache_write.kv_encode_write)
    before = [w.launches for w in counted]
    with pytest.raises(KernelError):
        flash_attention.flash_prefill(q, kv, kv, lens, lens * 0)
    with pytest.raises(KernelError):
        decode_attention.decode_attention(q[:, 0], cache, cache, lens, 0)
    with pytest.raises(KernelError):
        paged_attention.paged_attention(q[:, :1], cache[:, :1], cache[:, :1],
                                        table, lens, 0)
    codes = torch.zeros((1, 1, 2, 16, D), dtype=torch.uint8, device="cuda")
    with pytest.raises(KernelError):
        cache_write.kv_encode_write(
            kv.transpose(1, 2)[0], kv.transpose(1, 2)[0], codes,
            codes.clone(), None, None,
            torch.arange(8, device="cuda"), 0, 16)
    assert [w.launches for w in counted] == before


# -- weights in and out: files loaded onto the card, LoRA, native dequant --

def _loader_model(tmp_path):
    """A tiny llama (D=64, GQA 4:2) as a bf16 HF directory written by the
    port's writers, and its in-memory bf16 params."""
    import json
    from turboinfer_tpu_torch.config import ModelConfig
    from turboinfer_tpu_torch.loader import safetensors as st
    from turboinfer_tpu_torch.models import llama
    cfg = ModelConfig(vocab_size=512, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_size=512,
                      max_seq_len=128, architecture="llama", name="tiny")
    params = llama.init_params(cfg, seed=3, device="cpu")
    lw = params["layers"]
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm"],
         "lm_head.weight": params["lm_head"].T}
    names = dict(wq="self_attn.q_proj", wk="self_attn.k_proj",
                 wv="self_attn.v_proj", wo="self_attn.o_proj",
                 w_gate="mlp.gate_proj", w_up="mlp.up_proj",
                 w_down="mlp.down_proj")
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = lw["attn_norm"][i]
        t[f"{p}.post_attention_layernorm.weight"] = lw["ffn_norm"][i]
        for slot, n in names.items():
            t[f"{p}.{n}.weight"] = lw[slot][i].T
    d = tmp_path / "hf"
    d.mkdir()
    st.write_safetensors(str(d / "model.safetensors"), t)
    (d / "config.json").write_text(json.dumps(
        {"model_type": "llama", "vocab_size": 512, "hidden_size": 256,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 512,
         "max_position_embeddings": 128}))
    return str(d), cfg, params


@pytest.mark.cuda
def test_cuda_file_loaded_onto_cuda_matches_cpu_load(tmp_path):
    """A bf16 HF directory loaded straight onto the card: the params equal
    the CPU load's and the in-memory weights bit for bit, int4 g=64
    quantized on the card equals the CPU quantization, and the engine's
    greedy tokens equal those of the CPU-loaded params moved to the card;
    a TINQ round trip through the card gives the same tokens."""
    _need_cuda()
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             QuantizationConfig, QuantType)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader import load_engine, load_model_data, tinq
    from turboinfer_tpu_torch.models.common import params_to
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    d, cfg, params = _loader_model(tmp_path)
    on_card = load_model_data(d, device="cuda")
    on_cpu = load_model_data(d, device="cpu")
    assert on_card.params["layers"]["wq"].is_cuda
    for a, b, c in ((on_card.params["layers"][k], on_cpu.params["layers"][k],
                     params["layers"][k]) for k in params["layers"]):
        assert torch.equal(a.cpu(), b) and torch.equal(b, c)
    qc = QuantizationConfig(type=QuantType.INT4, group_size=64)
    q_card = quantize_params(on_card.params, qc)
    q_cpu = quantize_params(on_cpu.params, qc)
    for k in ("wq", "wo", "w_down"):
        assert torch.equal(q_card["layers"][k].data.cpu(),
                           q_cpu["layers"][k].data)
        assert torch.equal(q_card["layers"][k].scales.cpu(),
                           q_cpu["layers"][k].scales)
    icfg = InferenceConfig(max_seq_len=128, temperature=0.0, eos_token_id=-1)
    prompts = [[1, 5, 9, 33, 7, 80], [250, 2, 11]]
    want = [r.tokens for r in InferenceEngine(
        params_to(q_cpu, "cuda"), cfg, icfg,
        device="cuda").generate_batch(prompts, 12)]
    got = [r.tokens for r in InferenceEngine(
        q_card, cfg, icfg, device="cuda").generate_batch(prompts, 12)]
    assert got == want
    path = str(tmp_path / "m.tinq")
    tinq.save(path, q_card, cfg, qc)
    eng = load_engine(path, icfg, device="cuda")
    assert [r.tokens for r in eng.generate_batch(prompts, 12)] == want


@pytest.mark.cuda
def test_cuda_lora_on_int4_matches_plain(tmp_path):
    """An int4 base under an adapter on every slot: the kernels' prefill
    and decode logits against the plain path's on the CPU within 2% of
    max|logit|, greedy tokens equal, and the paged scheduler's tokens
    equal generate_batch's on the card."""
    _need_cuda()
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             QuantizationConfig, QuantType)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.models import llama
    from turboinfer_tpu_torch.models.common import params_to
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    _, cfg, params = _loader_model(tmp_path)
    q = quantize_params(params, QuantizationConfig(type=QuantType.INT4,
                                                   group_size=64))
    gen = torch.Generator().manual_seed(4)
    L, r = cfg.num_layers, 8
    dims = dict(wq=(256, 256), wk=(256, 128), wv=(256, 128), wo=(256, 256),
                w_gate=(256, 512), w_up=(256, 512), w_down=(512, 256))
    for slot, (n_in, n_out) in dims.items():
        q["layers"][f"lora_{slot}_a"] = (0.05 * torch.randn(
            (L, n_in, r), generator=gen)).to(torch.bfloat16)
        q["layers"][f"lora_{slot}_b"] = (0.05 * torch.randn(
            (L, r, n_out), generator=gen)).to(torch.bfloat16)
    sides = {dev: prepare_params(params_to(q, dev)) for dev in ("cuda", "cpu")}
    tok = torch.randint(1, 512, (2, 40), generator=gen, dtype=torch.int32)
    out = {}
    for dev, p in sides.items():
        cache = llama.init_cache(cfg, 2, device=dev)
        lg, cache = llama.forward(p, cfg, tok.to(dev), cache,
                                  fresh_prefill=True)
        nxt = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        step, _ = llama.forward(p, cfg, nxt.to(dev), cache)
        out[dev] = (lg.float().cpu(), step.float().cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert (a - b).abs().max().item() <= 2e-2 * b.abs().max().item()
    icfg = InferenceConfig(max_seq_len=128, temperature=0.0, eos_token_id=-1)
    prompts = [[1, 5, 9, 33, 7, 80], [250, 2, 11]]
    want = [r.tokens for r in InferenceEngine(
        sides["cuda"], cfg, icfg, device="cuda").generate_batch(prompts, 12)]
    sched = PagedContinuousScheduler(sides["cuda"], cfg, icfg, batch_slots=2,
                                     page_size=16, device="cuda")
    ids = [sched.submit(p, 12) for p in prompts]
    res = sched.run()
    assert [res[i].tokens for i in ids] == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Q4_0", "Q8_0", "Q4_K", "Q6_K"])
def test_cuda_machine_native_dequant_matches_numpy(name):
    """The native dequantizer builds on the GPU machine and equals the
    numpy forms on random blocks (fp16 scale fields finite)."""
    _need_cuda()
    import numpy as np
    from turboinfer_tpu_torch import native
    from turboinfer_tpu_torch.loader import gguf
    assert native.available(), native.last_error()
    t = {v: k for k, v in gguf.GGML_TYPE_NAMES.items()}[name]
    be, bb = gguf._BLOCK_LAYOUT[t]
    nb = 4096 // be * 64
    rng = np.random.default_rng(t)
    blocks = rng.integers(0, 256, size=(nb, bb), dtype=np.uint8)
    off = 208 if name == "Q6_K" else 0
    for o in ((0, 2) if name == "Q4_K" else (off,)):
        blocks[:, o:o + 2] = rng.normal(scale=0.05, size=nb).astype(
            np.float16).view(np.uint8).reshape(nb, 2)
    raw = blocks.reshape(-1)
    got = native.ggml_dequant(raw, t, nb * be)
    np.testing.assert_array_equal(got, gguf.dequantize_ggml_numpy(
        raw, t, nb * be))


def _text_model(kv="model"):
    """A tiny int4 model on the card (D=32) and its engine."""
    from turboinfer_tpu_torch.config import InferenceConfig, tiny_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    cfg = tiny_config(max_seq_len=128)
    params = create_synthetic_quantized_model(cfg, bits=4, group_size=64,
                                              device="cuda", seed=3).params
    icfg = InferenceConfig(max_seq_len=128, temperature=0.0, eos_token_id=-1,
                           kv_cache_dtype=kv)
    return cfg, params, icfg, InferenceEngine(params, cfg, icfg,
                                              device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("parent", [[2, 0, 2, 1], [3, 3, 3, 3], [0, 1, 2, 3]])
def test_cuda_beam_gather_matches_cpu(kv, parent):
    """The beam cache reordered by parent on the card equals the same
    gather on the CPU byte for byte (int8 codes with their f32 scale
    planes, fp8 as raw bytes), and positions past n stay as they were."""
    _need_cuda()
    *_, eng = _text_model(kv)
    cache = eng._take_cache(4)
    gen = torch.Generator().manual_seed(sum(parent))
    host = []
    for plane, _ in eng._cache_planes(cache, cache):
        x = torch.randint(0, 255, plane.shape, generator=gen).to(plane.dtype)
        plane.copy_(x.to("cuda"))
        host.append(x)
    p = torch.tensor(parent)
    eng._beam_gather(cache, p.to("cuda"), 37)
    torch.cuda.synchronize()
    for x, (plane, _) in zip(host, eng._cache_planes(cache, cache)):
        want = x.clone()
        want[:, :, :, :37] = x[:, p, :, :37]
        assert torch.equal(plane.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_cuda_stream_and_beam_one_match_generate(kv):
    """On the card, generate_stream's greedy tokens (bursts 1 and 5) and a
    width-1 beam search equal generate()'s; the stream launched the
    decode kernel once a layer a token."""
    _need_cuda()
    from turboinfer_tpu_torch import kernels
    cfg, _, _, eng = _text_model(kv)
    prompt = [1, 5, 9, 33, 7, 80, 250, 2, 11]
    want = eng.generate(prompt, 20).tokens[len(prompt):]
    for burst in (1, 5):
        kernels.reset_launch_counts()
        got = [c.token for c in eng.generate_stream(prompt, 20, burst=burst)]
        assert got == want
        assert kernels.launch_counts()["decode_attention"] == \
            cfg.num_layers * 19
    beam = eng.generate_beam_search(prompt, 20, beam_size=1)
    assert beam.tokens[len(prompt):] == want


@pytest.mark.cuda
def test_cuda_constrained_bias_row_matches_host_mask():
    """A constrained slot's bias row on the card is the host mask of its
    grammar state (plus the request's logit_bias) after every token, and
    the greedy output is a legal JSON prefix."""
    _need_cuda()
    import numpy as np
    from turboinfer_tpu_torch.engine.scheduler import \
        ContinuousBatchingScheduler
    from turboinfer_tpu_torch.structured import json_fsm
    from turboinfer_tpu_torch.tokenizer.bpe import BuiltinTokenizer
    cfg, params, icfg, _ = _text_model()
    tok = BuiltinTokenizer(vocab_size=cfg.vocab_size)
    s = ContinuousBatchingScheduler(params, cfg, icfg, batch_slots=2,
                                    tokenizer=tok, device="cuda")
    bias = {7: 1.5, 40: -2.0}
    rid = s.submit([1, 7, 9], 24, response_format="json_object",
                   logit_bias=bias)
    plain = s.submit([3, 3, 4], 24)
    user = np.zeros((cfg.vocab_size,), np.float32)
    for t, b in bias.items():
        user[t] = b
    checked = 0
    while s.pending:
        s.step()
        for slot, req in s._active.items():
            if req.rid != rid:
                continue
            mk = s._masker(req.response_format)
            want = mk.bias_row(req.struct_state, icfg.eos_token_id) + user
            np.testing.assert_array_equal(s.slot_bias[slot].cpu().numpy(),
                                          want)
            checked += 1
    res = s.run()
    assert checked > 0 and len(res[plain].tokens) == 3 + 24
    text = tok.decode(res[rid].tokens[3:])
    assert json_fsm.advance_bytes(json_fsm.initial(True),
                                  text.encode()) is not None
