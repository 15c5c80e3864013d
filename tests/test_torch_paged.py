"""The paged serving pieces of the port against the JAX package.

- paged_plain (what the wrapper runs on the CPU) against the Pallas
  paged decode/verify kernels in interpret mode;
- PageAllocator / PrefixPagePool driven by one operation sequence;
- forward_paged_decode / forward_paged_verify logits and pools against
  JAX on bridged params, including the -1 table row of an inactive slot
  (it must write trash page 0 and leave page P-1 alone);
- verify equals the chain of G decode steps on the same pages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.engine import paged_cache as jpc
from turboinfer_tpu.kernels.pallas import paged_attention as jpa
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.engine import paged_cache as tpc
from turboinfer_tpu_torch.kernels import dispatch
from turboinfer_tpu_torch.kernels import paged_attention as tpa
from turboinfer_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

# The Pallas kernel feeds the matrix unit bf16 operands even for f32
# inputs; the JAX package's own kernel tests use the same relative bound.
KERNEL_RTOL = 2e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _table(rng, B, P, max_pages, lens, page):
    """Shuffled ids drawn with replacement (rows share pages), -1 past
    each row's need."""
    table = rng.integers(0, P, (B, max_pages)).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-max(n, 1) // page):] = -1
    return table


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("gh", [1, 4])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("G", [1, 3, 5])
def test_paged_plain_matches_pallas(D, gh, page, G):
    rng = np.random.default_rng(D + 7 * gh + page + 100 * G)
    L, P, Hkv, B, max_pages = 2, 12, 2, 3, 5
    Hq = Hkv * gh
    lens = [0, 2 * page + 3, max_pages * page]
    kp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    q = rng.normal(size=(B, G, Hq, D)).astype(np.float32)
    table = _table(rng, B, P, max_pages, lens, page)
    kv = np.asarray(lens, np.int32)
    args = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
            jnp.asarray(kv))
    if G == 1:
        want = jpa.paged_decode_pallas(jnp.asarray(q[:, 0]), *args,
                                       layer_index=jnp.int32(1),
                                       interpret=True)[:, None]
    else:
        want = jpa.paged_verify_pallas(jnp.asarray(q), *args,
                                       layer_index=jnp.int32(1),
                                       interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(table),
                              torch.from_numpy(kv), 1)
    # rows whose query sees no key (kv_len < G) are undefined: the Pallas
    # kernel and the gather reference average different key sets there
    qpos = np.maximum(kv, 1)[:, None] - G + np.arange(G)[None, :]
    valid = qpos >= 0
    assert _rel(got.numpy()[valid], np.asarray(want)[valid]) < KERNEL_RTOL


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_plain_matches_pallas_full_tile(D, page):
    """The widest tile the kernel takes: G=16 tokens of a group of gh=8
    heads, R = 128 query rows a kv head, one sequence shorter than G
    (its early rows see no key) and one whose last page is partial."""
    rng = np.random.default_rng(D + page)
    L, P, Hkv, B, G, gh, max_pages = 1, 9, 1, 2, 16, 8, 4
    lens = [G - 5, 3 * page + 1]
    kp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    q = rng.normal(size=(B, G, Hkv * gh, D)).astype(np.float32)
    table = _table(rng, B, P, max_pages, lens, page)
    kv = np.asarray(lens, np.int32)
    want = jpa.paged_verify_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv), layer_index=jnp.int32(0), interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(table),
                              torch.from_numpy(kv), 0)
    qpos = kv[:, None] - G + np.arange(G)[None, :]
    valid = qpos >= 0
    assert valid.sum() == G + 11
    assert _rel(got.numpy()[valid], np.asarray(want)[valid]) < KERNEL_RTOL


@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["f32", "int8", "fp8"])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("window,cap", [(21, 2.0), (None, 2.0), (21, None),
                                        (600, 50.0)],
                         ids=["w21_cap2", "cap2", "w21", "w600_cap50"])
def test_paged_plain_window_softcap_matches_pallas(kind, G, window, cap):
    """paged_plain with a window and a softcap against the Pallas paged
    decode (G=1) and verify (G=5) kernels in interpret mode, over f32,
    int8 (scale pages) and fp8 pools: a window of 21 keys (not a page
    multiple) whose verify rows start their windows in different pages,
    caps the scores pass by 2-3x, and a cap they stay below."""
    from turboinfer_tpu_torch.models.common import encode_kv_scaled
    rng = np.random.default_rng(G + 3 * len(str(window)) + int(cap or 0))
    L, P, Hkv, page, D, B, max_pages, gh = 2, 12, 2, 16, 64, 3, 5, 2
    lens = [G + 2, 2 * page + 3, max_pages * page]

    def pool():
        x = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
        if kind is None:
            return jnp.asarray(x), None, torch.from_numpy(x), None
        q8, s8 = encode_kv_scaled(torch.from_numpy(x), {
            "int8": torch.int8, "fp8": torch.uint8}[kind])
        return (jnp.asarray(q8.numpy()), None if s8 is None else
                jnp.asarray(s8.numpy()), q8, s8)
    jk, jks, tk, tks = pool()
    jv, jvs, tv, tvs = pool()
    q = (2.0 * rng.normal(size=(B, G, Hkv * gh, D))).astype(np.float32)
    table = _table(rng, B, P, max_pages, lens, page)
    kv = np.asarray(lens, np.int32)
    args = (jk, jv, jnp.asarray(table), jnp.asarray(kv))
    kw = dict(layer_index=jnp.int32(1), window=window, softcap=cap,
              k_scale=jks, v_scale=jvs, interpret=True)
    if G == 1:
        want = jpa.paged_decode_pallas(jnp.asarray(q[:, 0]), *args,
                                       **kw)[:, None]
        got = dispatch.attention_paged_decode(
            torch.from_numpy(q[:, 0]), tk, tv, torch.from_numpy(table),
            torch.from_numpy(kv), 1, tks, tvs, window=window,
            softcap=cap)[:, None]
    else:
        want = jpa.paged_verify_pallas(jnp.asarray(q), *args, **kw)
        got = dispatch.attention_paged_verify(
            torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(kv), 1, tks, tvs, window=window, softcap=cap)
    assert _rel(got.numpy(), np.asarray(want)) < KERNEL_RTOL


def test_dispatch_paged_decode_is_verify_at_one_token():
    rng = np.random.default_rng(3)
    kp = torch.from_numpy(rng.normal(size=(2, 6, 2, 8, 32)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(2, 6, 2, 8, 32)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    table = torch.tensor([[3, 1, -1], [5, 0, 2]], dtype=torch.int32)
    kv = torch.tensor([9, 20], dtype=torch.int32)
    a = dispatch.attention_paged_decode(q, kp, vp, table, kv, 1)
    b = dispatch.attention_paged_verify(q[:, None], kp, vp, table, kv, 1)
    assert torch.equal(a, b[:, 0])


PAGED_FIELDS = ("k_pages", "v_pages", "block_table", "lengths",
                "k_scale_pages", "v_scale_pages")


# -- allocator and prefix pool ---------------------------------------------

def _drive(mod):
    """One operation sequence; returns everything observable."""
    seen = []
    a = mod.PageAllocator(6)
    x = a.alloc(3)
    a.release([x[1], -1])
    seen += [x, a.alloc(2), a.free_pages]
    with pytest.raises(RuntimeError):
        a.alloc(5)
    pool = mod.PrefixPagePool(5)
    keys = mod.prefix_page_keys(list(range(1, 20)), 4)
    seen.append([len(k) for k in keys])
    trash = pool.acquire()
    p1 = [pool.acquire(k) for k in keys[:2]]
    p2 = [pool.lookup(keys[0]), pool.lookup(keys[3])]
    pool.release(p1)
    seen += [trash, p1, p2, pool.available, pool.live_pages]
    pool.release([p2[0]])
    # the pool is dry: acquiring evicts the coldest zero-ref cached page
    p3 = [pool.acquire(k) for k in keys[2:4]] + [pool.acquire()]
    seen += [p3, pool.lookup(keys[0]), pool.lookup(keys[1]), pool.hits,
             pool.misses, pool.available, pool.live_pages]
    return seen


def test_allocator_and_prefix_pool_match_jax():
    assert _drive(tpc) == _drive(jpc)


# -- the paged forward ------------------------------------------------------

CFGS = {"tiny": dict(), "gqa_d64": dict(hidden_size=256, num_heads=4,
                                        num_kv_heads=2, intermediate_size=256,
                                        vocab_size=300)}


def _models(name):
    jcfg = ti.tiny_config(dtype=jnp.float32, **CFGS[name])
    tcfg = tconfig.tiny_config(dtype=torch.float32, **CFGS[name])
    jp = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("G", [1, 4])
def test_forward_paged_matches_jax(name, G):
    """Logits and both pools after the write, against JAX. Row 2 is an
    inactive slot: its table row is -1 and its length 0, so its writes
    must land in trash page 0, never in page P-1 (a torch -1 index would
    wrap there)."""
    jcfg, jp, tcfg, tp = _models(name)
    rng = np.random.default_rng(G)
    L, P, page, B = jcfg.num_layers, 10, 8, 3
    Hkv, D = jcfg.kv_heads, jcfg.head_dim_
    kp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    table = np.array([[3, 7, 1, -1], [8, 2, -1, -1], [-1, -1, -1, -1]],
                     np.int32)
    lengths = np.array([13, 6, 0], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B, G)).astype(np.int32)
    tcache = bridge.paged_cache_from_numpy(kp, vp, table, lengths,
                                           device="cpu")
    if G == 1:
        want = jllama.forward_paged_decode(
            jp, jcfg, jnp.asarray(tokens[:, 0]), jnp.asarray(kp),
            jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lengths))
        got = tllama.forward_paged_decode(
            tp, tcfg, torch.from_numpy(tokens[:, 0]), tcache.k_pages,
            tcache.v_pages, tcache.block_table, tcache.lengths)
    else:
        want = jllama.forward_paged_verify(
            jp, jcfg, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lengths))
        got = tllama.forward_paged_verify(
            tp, tcfg, torch.from_numpy(tokens), tcache.k_pages,
            tcache.v_pages, tcache.block_table, tcache.lengths)
    live = np.array([True, True, False])
    np.testing.assert_allclose(got[0].numpy()[live], np.asarray(want[0])[live],
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # Trap 1: the inactive row wrote page 0 and left page P-1 alone
    assert not np.allclose(got[1].numpy()[:, 0, :, :G], kp[:, 0, :, :G])
    np.testing.assert_array_equal(got[1].numpy()[:, P - 1], kp[:, P - 1])
    np.testing.assert_array_equal(got[2].numpy()[:, P - 1], vp[:, P - 1])


def test_verify_equals_decode_chain():
    """forward_paged_verify's G logits equal G chained
    forward_paged_decode steps on the same pages (as JAX tests its own),
    and the pools end equal."""
    _, _, tcfg, tp = _models("tiny")
    B, G, page = 2, 3, 8
    cache = tpc.init_paged_cache(tcfg, B, num_pages=20, page_size=page,
                                 max_seq=64, device="cpu")
    table = torch.arange(1, 17, dtype=torch.int32).reshape(B, 8)
    kp, vp = cache.k_pages, cache.v_pages
    rng = np.random.default_rng(0)
    lengths = np.array([5, 11])
    for t in range(int(lengths.max())):
        toks = torch.from_numpy(rng.integers(1, 900, B).astype(np.int32))
        tllama.forward_paged_decode(tp, tcfg, toks, kp, vp, table,
                                    torch.from_numpy(np.minimum(t, lengths)))
    kp0, vp0 = kp.clone(), vp.clone()
    chunk = torch.from_numpy(rng.integers(1, 900, (B, G)).astype(np.int32))
    lens = torch.from_numpy(lengths.astype(np.int32))
    want = torch.stack([tllama.forward_paged_decode(
        tp, tcfg, chunk[:, g], kp, vp, table, lens + g)[0]
        for g in range(G)], dim=1)
    got, kp2, vp2 = tllama.forward_paged_verify(tp, tcfg, chunk, kp0, vp0,
                                                table, lens)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(kp2, kp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vp2, vp, rtol=1e-5, atol=1e-5)


def test_append_token_and_gather_sequence_match_jax():
    jcfg, _, tcfg, _ = _models("tiny")
    rng = np.random.default_rng(9)
    L, Hkv, D, B, page = jcfg.num_layers, jcfg.kv_heads, jcfg.head_dim_, 3, 8
    jcache = jpc.init_paged_cache(jcfg, B, num_pages=8, page_size=page,
                                  max_seq=32)
    table = np.array([[2, 5, -1, -1], [1, -1, -1, -1], [4, 3, 6, -1]],
                     np.int32)
    # row 1 has no page at 8; row 2 fills its last page on the 2nd append
    # and must write nothing on the 3rd
    lengths = np.array([9, 8, 23], np.int32)
    table[2, 3] = 7
    jcache = jcache._replace(block_table=jnp.asarray(table),
                             lengths=jnp.asarray(lengths))
    tcache = bridge.paged_cache_from_numpy(
        np.asarray(jcache.k_pages), np.asarray(jcache.v_pages), table,
        lengths, device="cpu")
    for _ in range(3):
        k = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
        v = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
        jcache = jpc.append_token(jcache, jnp.asarray(k), jnp.asarray(v))
        tcache = tpc.append_token(tcache, torch.from_numpy(k),
                                  torch.from_numpy(v))
    got = bridge.to_numpy(tcache)
    for name in ("k_pages", "v_pages", "block_table", "lengths"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jcache, name)))
    for g, w in zip(tpc.gather_sequence(tcache, 32),
                    jpc.gather_sequence(jcache, 32)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_int8_pool_is_not_ported_yet():
    """(Name kept from before the int8 pool was ported.) The int8 pool's
    layout equals JAX's init_paged_cache: int8 pages, two distinct f32
    scale-page buffers [L, P, Hkv, page], the -1 table and zero lengths;
    an fp8 pool is uint8 bits without scales."""
    jcfg, _, tcfg, _ = _models("tiny")
    j = jpc.init_paged_cache(jcfg, 2, 4, 8, max_seq=40, dtype=jnp.int8)
    t = tpc.init_paged_cache(tcfg, 2, 4, 8, max_seq=40, dtype=torch.int8,
                             device="cpu")
    got = bridge.to_numpy(t)
    for name in PAGED_FIELDS:
        w = np.asarray(getattr(j, name))
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w)
    assert t.k_scale_pages.data_ptr() != t.v_scale_pages.data_ptr()
    f = tpc.init_paged_cache(tcfg, 2, 4, 8, max_seq=40, dtype=torch.uint8,
                             device="cpu")
    assert f.k_pages.dtype == torch.uint8 and f.k_scale_pages is None
