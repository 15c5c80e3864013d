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
                                          flash_attention, qmm)

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


@pytest.mark.cuda
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 4), (64, 8, 2), (128, 2, 1)])
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
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 4), (64, 8, 2), (128, 2, 1)])
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
