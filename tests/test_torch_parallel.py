"""parallel/ of the port in one process: the mesh helpers, each rank's
parameter slices and caches against the JAX package's device shards,
the placement refusals, and that no collective runs off a mesh.

A rank's slice needs no process group: a Mesh of shape (1, 2) with
coordinates (0, r) is rank r's view. JAX's side is shard_params /
shard_cache on the conftest's virtual devices; JAX's device r holds
rank r's block (mesh.py reshapes the device list row-major, as the port
numbers its ranks). Slices are compared byte for byte.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.parallel import mesh as jmesh
from turboinfer_tpu.parallel import shardings as jsh
from turboinfer_tpu.quant.quantizer import quantize_params as jquantize
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from turboinfer_tpu_torch.loader import ckpt
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.parallel import comm
from turboinfer_tpu_torch.parallel import mesh as tmesh
from turboinfer_tpu_torch.parallel import shardings as tsh

from test_torch_moe import jax_to_numpy
from test_torch_tp import make_weights

torch.set_num_threads(2)

LLAMA = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=256, max_seq_len=64)
MOE = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=256, moe_intermediate_size=128,
           num_experts=4, experts_per_token=2, shared_expert_size=128,
           attn_bias=True, norm_topk_prob=False, max_seq_len=64,
           architecture="qwen2_moe")
DEEPSEEK = dict(vocab_size=256, hidden_size=128, num_layers=3, num_heads=4,
                intermediate_size=256, moe_intermediate_size=128,
                shared_expert_size=128, num_experts=4, experts_per_token=2,
                first_k_dense_replace=1, kv_lora_rank=64,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                q_lora_rank=64, max_seq_len=64, architecture="deepseek_v3")
TREES = {"llama": LLAMA, "moe": MOE, "deepseek": DEEPSEEK}
QUANTS = {"int4": (JQuantType.INT4, True), "int8": (JQuantType.INT8, True),
          "int4_zp": (JQuantType.INT4, False)}


def rank_view(r, shape=(1, 2)):
    """Rank r's view of a mesh (no process group needed to slice)."""
    return tmesh.Mesh(shape=shape, coords=(r // shape[1], r % shape[1]),
                      device=torch.device("cpu"))


def jax_shard(arr, r):
    """JAX device r's block of a placed array."""
    dev = jax.devices()[r]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


def _as_np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _pairs(jtree, ttree, specs, path=()):
    """(path, JAX leaf, port leaf) of every slot a spec set names."""
    for k, s in specs.items():
        if k not in jtree:
            continue
        if isinstance(s, dict):
            yield from _pairs(jtree[k], ttree[k], s, path + (k,))
        else:
            yield path + (k,), jtree[k], ttree[k]


# -- mesh ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_pick_mesh_shape_matches_jax(n):
    for kv in (1, 2, 3, 4, 5, 8, 12, 32):
        assert tmesh.pick_mesh_shape(n, kv) == jmesh.pick_mesh_shape(n, kv)


def test_mesh_views_and_refusals():
    m = tmesh.single_device_mesh("cpu")
    assert (m.shape, m.coords, m.size, m.rank) == ((1, 1), (0, 0), 1, 0)
    assert tmesh.make_mesh(device="cpu").shape == (1, 1)
    v = rank_view(3, (2, 2))
    assert (v.data_rank, v.tp_rank, v.rank) == (1, 1, 3)
    with pytest.raises(ValueError, match="process count"):
        tmesh.make_mesh((1, 2), device="cpu")     # no group: one process
    with pytest.raises(ValueError, match="next slice|item 13"):
        tmesh.make_mesh((1, 1), axis_names=("pp", "tp"), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tmesh.initialize_distributed("mpi", "file:///x", 1, 0)


# -- parameter slices -----------------------------------------------------

_W = {}


def weights(tree, quant):
    """(JAX config, JAX params, port params) of a tiny tree, fp or the
    quantizer's g=64 output (int4 / int8, symmetric or zero points)."""
    if (tree, quant) not in _W:
        jcfg, jp = make_weights(TREES[tree], seed=3)
        if quant != "fp":
            qt, sym = QUANTS[quant]
            jp = jquantize(jp, JQuantCfg(type=qt, group_size=64,
                                         symmetric=sym))
        _W[tree, quant] = (jcfg, jp, bridge.params_from_numpy(
            jax_to_numpy(jp), device="cpu"))
    return _W[tree, quant]


@pytest.mark.parametrize("quant", ["fp", "int4", "int8", "int4_zp"])
@pytest.mark.parametrize("tree", list(TREES))
def test_rank_slices_are_jax_device_shards(tree, quant):
    """Every slot of the family's spec set: rank r's slice (data, scales,
    zero points) is byte for byte JAX device r's shard."""
    jcfg, jp, tp = weights(tree, quant)
    jspecs = {"llama": jsh.param_specs, "moe": jsh.moe_param_specs,
              "deepseek": jsh.deepseek_param_specs}[tree]()
    placed = jsh.shard_params(jp, jmesh.make_mesh(
        (1, 2), devices=jax.devices()[:2]), jspecs)
    tcfg = ModelConfig(dtype=torch.float32, **TREES[tree])
    assert tsh.specs_for(tcfg) == {
        "llama": tsh.param_specs, "moe": tsh.moe_param_specs,
        "deepseek": tsh.deepseek_param_specs}[tree]()
    n = 0
    for r in (0, 1):
        mine = tsh.shard_params(tp, rank_view(r), tsh.specs_for(tcfg))
        for path, jleaf, tleaf in _pairs(placed, mine, jspecs):
            if isinstance(jleaf, JQEmbed):
                parts = [("data", jleaf.data, tleaf.data),
                         ("scales", jleaf.scales, tleaf.scales)]
            elif isinstance(jleaf, JQTensor):
                assert isinstance(tleaf, QTensor), path
                parts = [("data", jleaf.data, tleaf.data),
                         ("scales", jleaf.scales, tleaf.scales)]
                if jleaf.zero_points is not None:
                    parts.append(("zp", jleaf.zero_points,
                                  tleaf.zero_points))
            else:
                parts = [("", jleaf, tleaf)]
            for _, ja, ta in parts:
                want = jax_shard(ja, r)
                if want.dtype.name == "bfloat16":
                    want = want.view(np.int16)
                got = _as_np(ta)
                assert got.shape == want.shape, path
                assert got.dtype == want.dtype, path
                assert np.array_equal(got, want), path
                n += 1
    assert n > 20


def test_port_only_slots_split_by_head():
    """Slots no JAX spec names: q/k/v biases by column, a whole-width q/k
    norm with q/k, a per-head one replicated, LoRA B's columns of a
    column slot and A's rows of a row slot, GPT-OSS's sinks by head and
    its b_o replicated."""
    H, L = 8, 1
    layers = {"wq": torch.zeros(L, H, 8), "wk": torch.zeros(L, H, 4),
              "wo": torch.zeros(L, 8, H),
              "b_q": torch.arange(8.).reshape(1, 8),
              "q_norm": torch.arange(8.).reshape(1, 8),
              "k_norm": torch.arange(2.).reshape(1, 2),
              "sinks": torch.arange(4.).reshape(1, 4),
              "b_o": torch.arange(8.).reshape(1, 8),
              "lora_wq_a": torch.ones(L, H, 2),
              "lora_wq_b": torch.arange(16.).reshape(1, 2, 8),
              "lora_wo_a": torch.arange(16.).reshape(1, 8, 2),
              "lora_wo_b": torch.ones(L, 2, H)}
    got = tsh.shard_params({"layers": layers}, rank_view(1))["layers"]
    assert got["b_q"].tolist() == [[4., 5., 6., 7.]]
    assert got["q_norm"].tolist() == [[4., 5., 6., 7.]]      # whole width
    assert got["k_norm"].tolist() == [[0., 1.]]              # per head
    assert got["sinks"].tolist() == [[2., 3.]]
    assert got["b_o"] is layers["b_o"]
    assert got["lora_wq_a"] is layers["lora_wq_a"]
    assert got["lora_wq_b"].shape == (1, 2, 4)
    assert got["lora_wo_a"][0, 0].tolist() == [8., 9.]
    assert got["lora_wo_b"] is layers["lora_wo_b"]


# -- refusals ------------------------------------------------------------------

def _cut_group_tree():
    """A llama tree whose w_down has 3 groups of 64 along K."""
    jcfg, jp = make_weights(dict(LLAMA, intermediate_size=192), seed=2)
    return jcfg, jquantize(jp, JQuantCfg(type=JQuantType.INT4,
                                         group_size=64))


def test_group_count_that_does_not_divide_raises_in_both():
    jcfg, jp = _cut_group_tree()
    with pytest.raises(ValueError):
        jsh.shard_params(jp, jmesh.make_mesh((1, 2),
                                             devices=jax.devices()[:2]))
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    with pytest.raises(ValueError, match="w_down.*quantization group"):
        tsh.shard_params(tp, rank_view(0))


def test_checkpoint_restore_refuses_to_cut_a_group(tmp_path):
    """JAX's restore replicates such an axis; the port refuses
    (ROADMAP §2)."""
    jcfg, jp = _cut_group_tree()
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    cfg = ModelConfig(dtype=torch.float32, **dict(LLAMA,
                                                  intermediate_size=192))
    ckpt.save_checkpoint(str(tmp_path), tp, cfg)
    with pytest.raises(ValueError, match="quantization group"):
        ckpt.load_checkpoint(str(tmp_path), mesh=rank_view(1))


def test_checkpoint_restore_gives_each_rank_its_slice(tmp_path):
    jcfg, jp, tp = weights("moe", "int4")
    cfg = ModelConfig(dtype=torch.float32, **MOE)
    ckpt.save_checkpoint(str(tmp_path), tp, cfg)
    for r in (0, 1):
        got, cfg2, _ = ckpt.load_checkpoint(str(tmp_path), mesh=rank_view(r))
        want = tsh.rank_params(tp, cfg, rank_view(r))
        assert cfg2 == cfg
        for k in ("we_down", "ws_down", "wq", "b_q"):
            g, w = got["layers"][k], want["layers"][k]
            if isinstance(w, QTensor):
                assert g.shape == w.shape
                g, w = g.data, w.data
            assert torch.equal(g, w), k


def test_column_split_must_leave_eight_columns_a_rank():
    jcfg, jp = make_weights(dict(LLAMA, vocab_size=520), seed=2)
    jp = jquantize(jp, JQuantCfg(type=JQuantType.INT4, group_size=64))
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    with pytest.raises(ValueError, match="lm_head.*multiple of 8"):
        tsh.shard_params(tp, rank_view(0))


def test_heads_that_do_not_divide_and_fused_trees_raise():
    cfg = ModelConfig(**dict(LLAMA, num_kv_heads=1))
    with pytest.raises(ValueError, match="whole heads"):
        tsh.local_config(cfg, 2)
    ok = ModelConfig(**LLAMA)
    local = tsh.local_config(ok, 2)
    assert (local.num_heads, local.kv_heads, local.head_dim_) == (2, 1, 32)
    assert tsh.local_config(ok.replace(architecture="gpt2"), 2).num_heads == 4
    with pytest.raises(ValueError, match="unfused"):
        tsh.shard_params({"layers": {"wqkv": torch.zeros(1, 4, 8)}},
                         rank_view(0))
    # the spec set is the family's, as JAX's cli picks it (no argument
    # chooses another: each rank-local forward follows its own)
    assert tsh.specs_for(ok) == tsh.param_specs()
    assert tsh.specs_for(ModelConfig(**MOE)) == tsh.moe_param_specs()
    assert tsh.specs_for(ModelConfig(**DEEPSEEK)) == \
        tsh.deepseek_param_specs()


def test_pipeline_and_context_parallel_refuse_naming_the_next_slice():
    cfg = ModelConfig(dtype=torch.float32, **LLAMA)
    p = tllama.init_params(cfg, device="cpu")
    for mode in ("pp", "cp"):
        with pytest.raises(NotImplementedError, match="next slice"):
            InferenceEngine(p, cfg, mesh=tmesh.single_device_mesh("cpu"),
                            parallel=mode)
        with pytest.raises(NotImplementedError, match="next slice"):
            ContinuousBatchingScheduler(p, cfg, parallel=mode, device="cpu")
    with pytest.raises(ValueError, match="parallel must be"):
        InferenceEngine(p, cfg, device="cpu", parallel="zz")


# -- caches ----------------------------------------------------------------

def _jax_placed(cache, cls, place):
    """A port cache (of the whole model and batch) as JAX's cache class
    `cls`, placed by JAX's shard_cache / shard_paged_cache."""
    return place(cls(**{k: None if v is None else jnp.asarray(v.numpy())
                        for k, v in cache._asdict().items()}))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("B,Hkv", [(4, 2), (3, 2), (4, 1)],
                         ids=["split", "odd_batch", "latent"])
def test_cache_slices_are_jax_device_shards(shape, B, Hkv):
    """The cache a rank makes for itself (init_cache on local_config, for
    data_rows' rows, as the engine does) has the shape of JAX's device
    shard under shard_cache: batch over data and heads over tp where they
    divide, else replicated, int8 scale planes alike, the MLA latent
    whole; data_rows picks the rows of JAX's shard."""
    from turboinfer_tpu_torch.models import registry
    cfg = ModelConfig(dtype=torch.float32,
                      **(DEEPSEEK if Hkv == 1 else LLAMA))
    model = registry.get_model(cfg.architecture)
    whole = model.init_cache(cfg, B, max_seq=8, dtype=torch.int8,
                             device="cpu")
    whole = whole._replace(length=torch.arange(B, dtype=torch.int32))
    n = shape[0] * shape[1]
    jc = _jax_placed(whole, jllama.KVCache, lambda c: jsh.shard_cache(
        c, jmesh.make_mesh(shape, devices=jax.devices()[:n])))
    for r in range(n):
        view = rank_view(r, shape)
        first, rows = tsh.data_rows(B, view)
        mine = model.init_cache(tsh.local_config(cfg, shape[1]), rows,
                                max_seq=8, dtype=torch.int8, device="cpu")
        for name in ("k", "v", "k_scale", "v_scale"):
            got, want = getattr(mine, name), jax_shard(getattr(jc, name), r)
            assert tuple(got.shape) == want.shape, name
            assert _as_np(got).dtype == want.dtype, name
        np.testing.assert_array_equal(np.arange(first, first + rows),
                                      jax_shard(jc.length, r))


@pytest.mark.parametrize("Hkv", [2, 1], ids=["heads", "latent"])
def test_paged_cache_slices_are_jax_device_shards(Hkv):
    """A rank's page pool (init_paged_cache on local_config, as the paged
    scheduler makes it) has the shapes of JAX's shard_paged_cache device
    shards: heads over tp, a latent pool, the table and lengths whole."""
    from turboinfer_tpu.engine.paged_cache import PagedKVCache as JPaged
    from turboinfer_tpu_torch.engine import paged_cache as tpc
    cfg = ModelConfig(dtype=torch.float32,
                      **(DEEPSEEK if Hkv == 1 else LLAMA))
    kw = dict(num_pages=5, page_size=4, max_seq=12, dtype=torch.int8,
              device="cpu")
    whole = tpc.init_paged_cache(cfg, 2, **kw)
    jc = _jax_placed(whole, JPaged, lambda c: jsh.shard_paged_cache(
        c, jmesh.make_mesh((1, 2), devices=jax.devices()[:2])))
    for r in range(2):
        mine = tpc.init_paged_cache(tsh.local_config(cfg, 2), 2, **kw)
        for name in ("k_pages", "v_pages", "block_table", "lengths",
                     "k_scale_pages", "v_scale_pages"):
            got, want = getattr(mine, name), jax_shard(getattr(jc, name), r)
            assert tuple(got.shape) == want.shape, name
            assert _as_np(got).dtype == want.dtype, name


# -- off a mesh ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "mixtral"])
def test_no_mesh_and_a_one_rank_mesh_call_no_collective(arch):
    """mesh=None and a (1, 1) mesh: the module itself runs (no sharded
    view), no collective is issued, and the tokens are the same."""
    kw = dict(LLAMA, architecture=arch)
    if arch == "mixtral":
        kw.update(num_experts=4, experts_per_token=2)
    cfg = ModelConfig(dtype=torch.float32, **kw)
    from turboinfer_tpu_torch.models import registry
    p = registry.get_model(arch).init_params(cfg, device="cpu")
    before = comm.calls
    toks = []
    for mesh in (None, tmesh.single_device_mesh("cpu")):
        eng = InferenceEngine(p, cfg, InferenceConfig(max_seq_len=64),
                              device="cpu", mesh=mesh)
        assert eng._model is registry.get_model(arch)
        toks.append(eng.generate_batch([[1, 2, 3], [4, 5]], 6,
                                       temperature=0.0))
    assert [r.tokens for r in toks[0]] == [r.tokens for r in toks[1]]
    assert comm.calls == before
    x = torch.ones(2, 3)
    with comm.active(tmesh.single_device_mesh("cpu")):
        assert comm.tp_sum(x) is x and comm.tp_size() == 1
        assert comm.gather_vocab(x, 99) is x
    assert comm.calls == before


def test_a_mesh_makes_its_cuda_device_current(monkeypatch):
    """make_mesh and single_device_mesh make cuda:i the current device:
    the kernels' ctypes launches and the SM count resolve on it, so rank
    r on cuda:r needs it before its first launch. A device without an
    index, and the CPU, leave it alone."""
    made = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", made.append)
    m = tmesh.make_mesh((1, 1), device="cuda:3")
    assert m.device == torch.device("cuda:3") and made == [m.device]
    assert tmesh.single_device_mesh("cuda:1").device == made[-1]
    tmesh.make_mesh((1, 1), device="cuda")
    tmesh.single_device_mesh("cpu")
    assert made == [torch.device("cuda:3"), torch.device("cuda:1")]


def test_serve_tp_puts_each_rank_on_its_local_card(monkeypatch):
    """`serve --tp N` under torchrun: rank r's mesh is made on
    cuda:LOCAL_RANK over NCCL (and so made current), gloo on the CPU."""
    import argparse
    from turboinfer_tpu_torch import cli
    seen = []
    monkeypatch.setattr(tmesh, "initialize_distributed",
                        lambda backend, *a: seen.append(backend))
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda shape, device: seen.append((shape, device)))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for device in ("cuda", "cpu"):
        cli._serve_mesh(argparse.Namespace(tp=2, device=device,
                                           dist_init="env://"))
    assert seen == ["nccl", ((1, 2), "cuda:1"), "gloo", ((1, 2), "cpu")]


def test_a_data_rank_draws_what_one_process_draws():
    """categorical(draw=(first, total)) takes rows first.. of the noise
    drawn for the whole batch: two data ranks' blocks are the rows one
    process samples, and each generator moves as far."""
    from turboinfer_tpu_torch.engine import sampling
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(1))
    whole = sampling.categorical(torch.Generator().manual_seed(7), logits)
    for first in (0, 2):
        g = torch.Generator().manual_seed(7)
        got = sampling.categorical(g, logits[first:first + 2],
                                   draw=(first, 4))
        assert torch.equal(got, whole[first:first + 2])
        h = torch.Generator().manual_seed(7)
        sampling.categorical(h, logits)
        assert torch.equal(g.get_state(), h.get_state())


def test_expert_slots_mask_other_ranks_experts():
    """local_slots: ids outside this rank's block clamp to a local plane
    and weigh 0 (no host sync picks the local experts)."""
    from turboinfer_tpu_torch.models.moe import local_slots
    top = torch.tensor([[[0, 3], [2, 1]]])
    gates = torch.tensor([[[0.6, 0.4], [0.7, 0.3]]])
    loc, g = local_slots(top, gates, 2, 2)
    assert loc.tolist() == [[[0, 1], [0, 0]]]
    assert torch.equal(g, gates * torch.tensor([[[0., 1.], [1., 0.]]]))
