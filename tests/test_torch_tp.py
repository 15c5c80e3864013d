"""The port's (data, tp) parallelism on 2 and 4 gloo ranks on the CPU,
against the JAX package's mesh engine on the conftest's virtual devices.

The ranks (tests/torch_tp_worker.py, spawned with torch.multiprocessing
and a file:// store under tmp_path) import the port only: this process
makes each model's weights with the JAX package, passes them to the
ranks as numpy (bridge.py's format) and runs the same calls through
InferenceEngine(..., mesh=make_mesh(shape)) with the family's spec set.
All in f32: logits within 1e-4 of max|logit| (the port's usual
cross-package bound), greedy trajectories token for token. The llama
family's cases are here; the MoE, DeepSeek, GPT-OSS and GPT-2 cases are
in tests/test_torch_tp_families.py, on the same helpers.

One spawn serves every case of a mesh shape (a spawn costs ~4 s):
  (1, 2) llama int4 (every engine path, checkpoint restore, sampled
         tokens), Qwen2 biases, OLMoE-style whole-width q/k norms on the
         llama body, Gemma-2's post norms and softcaps, a LoRA adapter;
  (2, 1) data parallelism;  (2, 2) four ranks.
The schedulers and `serve --tp 2` are in tests/test_torch_tp_serving.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import InferenceConfig as JInferenceConfig
from turboinfer_tpu.config import ModelConfig as JModelConfig
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.models import registry as jregistry
from turboinfer_tpu.parallel import mesh as jmesh
from turboinfer_tpu.parallel import shardings as jsh
from turboinfer_tpu.quant.quantizer import quantize_params as jquantize

import torch_tp_worker
from test_torch_moe import jax_to_numpy
from turboinfer_tpu_torch import bridge

torch.set_num_threads(2)

LOGIT_RTOL = 1e-4          # of max|logit|

LLAMA = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=256, max_seq_len=128,
             rope_theta=10000.0, name="tiny-llama")
ICFG = dict(max_seq_len=128, eos_token_id=-1)
PROMPTS = [[1, 5, 7, 9], [3, 4, 5, 6, 7, 8, 9, 10, 11]]
TOKENS = np.array([[5, 9, 31, 7, 200, 18, 44, 3, 91],
                   [77, 12, 640, 5, 5, 301, 9, 2, 1000]], np.int32)


def numpy_to_jax(tree):
    """A bridge-format numpy tree as the JAX package's param tree."""
    if isinstance(tree, dict):
        if {"data", "scales", "bits"} <= set(tree):
            zp = tree["zero_points"]
            return JQTensor(data=jnp.asarray(tree["data"]),
                            scales=jnp.asarray(tree["scales"]),
                            zero_points=None if zp is None
                            else jnp.asarray(zp), bits=tree["bits"],
                            group_size=tree["group_size"],
                            shape=tuple(tree["shape"]))
        if set(tree) == {"data", "row_scales"}:
            return JQEmbed(jnp.asarray(tree["data"]),
                           jnp.asarray(tree["row_scales"]))
        return {k: numpy_to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def make_weights(cfg_kw, quant=False, seed=1, edit=None):
    """(JAX config, JAX params) of a tiny model: the port's init_params
    (N(0, 1/fan_in) from a seed) with every norm and bias moved off its
    init, so that the slots that replicate or split by head show in the
    logits; `edit(layers)` may change slots (numpy); quant: int4 g=64 by
    the port's quantizer, byte for byte the JAX package's
    (tests/test_torch_qtensor.py)."""
    from turboinfer_tpu_torch.config import ModelConfig
    from turboinfer_tpu_torch.models import registry
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
    tcfg = ModelConfig(dtype=torch.float32, **cfg_kw)
    tp = registry.get_model(tcfg.architecture).init_params(
        tcfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 2)
    for k, a in tp["layers"].items():
        if "norm" in k or k.startswith("b_") or k == "sinks":
            a.add_(torch.from_numpy(0.2 * rng.normal(size=tuple(a.shape))
                                    ).to(a.dtype))
    if edit is not None:
        edit(tp["layers"], tcfg)
    if quant:
        tp = quantize_params(tp, QuantizationConfig(type=QuantType.INT4,
                                                    group_size=64))
    jcfg = JModelConfig(dtype=jnp.float32, **cfg_kw)
    return jcfg, numpy_to_jax(bridge.to_numpy(tp))


def llama_case(name, quant=False, seed=1, edit=None, **kw):
    """(JAX config, JAX params) of a llama-family case."""
    return make_weights(dict(LLAMA, **kw), quant, seed, edit)


def with_lora(layers, cfg, r=4):
    """A LoRA adapter on wq/wv (column slots) and wo/w_down (row slots),
    B non-zero (loader/lora.py's slot names)."""
    gen = torch.Generator().manual_seed(5)
    L = cfg.num_layers
    for slot in ("wq", "wv", "wo", "w_down"):
        K, N = layers[slot].shape[1:]
        layers[f"lora_{slot}_a"] = 0.1 * torch.randn((L, K, r),
                                                     generator=gen)
        layers[f"lora_{slot}_b"] = 0.1 * torch.randn((L, r, N),
                                                     generator=gen)


def wide_qk_norms(layers, cfg):
    """q/k norms over the whole projection ([L, Hq*D], [L, Hkv*D]), as
    OLMoE ships them."""
    gen = torch.Generator().manual_seed(4)
    L, D = cfg.num_layers, cfg.head_dim_
    for k, n in (("q_norm", cfg.num_heads), ("k_norm", cfg.kv_heads)):
        layers[k] = 1 + 0.2 * torch.randn((L, n * D), generator=gen)


def cfg_kwargs(cfg):
    """A JAX ModelConfig's fields for the port's ModelConfig (f32)."""
    import dataclasses
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d.pop("dtype")
    d["rope_mode"] = d["rope_mode"].value
    return d


def case(name, cfg, jp, ops, icfg=ICFG):
    return {"name": name, "cfg": cfg_kwargs(cfg), "params": jax_to_numpy(jp),
            "icfg": dict(icfg), "ops": ops, "_jcfg": cfg, "_jp": jp}


def spawn(tmpdir, world, mesh=None, cases=(), serve=None):
    """The worker's spawn without this module's private keys."""
    return torch_tp_worker.spawn(
        tmpdir, world, mesh, [{k: v for k, v in c.items()
                               if not k.startswith("_")} for c in cases],
        serve)


# -- the JAX side ----------------------------------------------------------

def specs_for(cfg):
    fam = jregistry.get_model(cfg.architecture).__name__.rsplit(".", 1)[-1]
    return {"moe": jsh.moe_param_specs,
            "deepseek": jsh.deepseek_param_specs}.get(fam, jsh.param_specs)()


def jax_mesh(shape):
    return jmesh.make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


_J = {}


def jax_engine(c, shape=(1, 2)):
    key = (c["name"], shape)
    if key not in _J:
        _J[key] = ti.InferenceEngine(
            c["_jp"], c["_jcfg"], JInferenceConfig(**c["icfg"]),
            mesh=jax_mesh(shape), param_specs=specs_for(c["_jcfg"]))
    return _J[key]


def jax_logits(c, tokens, shape=(1, 2)):
    je = jax_engine(c, shape)
    model = jregistry.get_model(c["_jcfg"].architecture)
    fn = jax.jit(model.forward_no_cache, static_argnums=(1,))
    return np.asarray(fn(je.params, c["_jcfg"], jnp.asarray(tokens)))


def jax_batch(c, prompts, n, shape=(1, 2)):
    return [r.tokens for r in jax_engine(c, shape).generate_batch(
        prompts, n, temperature=0.0)]


def close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def same_on_ranks(outs, name):
    """Every rank's results of a case, which must be equal."""
    first = outs[0][name]
    for o in outs[1:]:
        for a, b in zip(first, o[name]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    return first


# -- (1, 2): the llama family ----------------------------------------------

def llama_cases(tmpdir):
    ckpt = os.path.join(tmpdir, "ckpt")
    int4 = llama_case("int4", quant=True)
    return [
        case("int4", *int4, [
            ("logits", TOKENS), ("batch", PROMPTS, 12),
            ("sample", PROMPTS, 8), ("beam", PROMPTS[1], 6, 3),
            ("logprobs", TOKENS[1].tolist()), ("stream", PROMPTS[0], 10),
            ("ckpt", ckpt, PROMPTS, 8), ("calls",)]),
        case("qwen2", *llama_case("qwen2", attn_bias=True,
                                  architecture="qwen2", rope_theta=1e6),
             [("logits", TOKENS), ("batch", PROMPTS, 10)]),
        case("wide_qk_norm", *llama_case("wide", qk_norm=True,
                                         edit=wide_qk_norms),
             [("logits", TOKENS), ("batch", PROMPTS, 10)]),
        case("gemma2", *llama_case(
            "gemma2", architecture="gemma2", norm_offset=True,
            scale_embeddings=True, post_norms=True, hidden_act="gelu",
            attn_scale=24.0 ** -0.5, attn_logit_softcap=0.5,
            final_logit_softcap=0.7, sliding_window=4,
            sliding_window_pattern=2, tie_embeddings=True,
            rms_norm_eps=1e-6),
             [("logits", TOKENS), ("batch", PROMPTS, 10)]),
        case("lora", *llama_case("lora", edit=with_lora),
             [("logits", TOKENS), ("batch", PROMPTS, 10)]),
    ]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp2"))
    cases = {c["name"]: c for c in llama_cases(d)}
    return cases, spawn(d, 2, (1, 2), cases.values())


NAMES = ["int4", "qwen2", "wide_qk_norm", "gemma2", "lora"]


@pytest.mark.parametrize("name", NAMES)
def test_tp2_logits_match_jax_mesh(tp2, name):
    cases, outs = tp2
    got = same_on_ranks(outs, name)[0]
    close(got, jax_logits(cases[name], TOKENS))


@pytest.mark.parametrize("name", NAMES)
def test_tp2_greedy_tokens_match_jax_mesh(tp2, name):
    cases, outs = tp2
    c = cases[name]
    i = [op[0] for op in c["ops"]].index("batch")
    _, prompts, n = c["ops"][i]
    assert same_on_ranks(outs, name)[i] == jax_batch(c, prompts, n)


def test_tp2_sampled_tokens_agree_on_every_rank(tp2):
    """temperature 0.9: gathered logits and one seeded generator a rank
    give every rank of the tp group the same tokens."""
    _, outs = tp2
    got = same_on_ranks(outs, "int4")[2]
    assert all(len(r) > 4 for r in got)


def test_tp2_beam_and_logprobs_match_jax_mesh(tp2):
    cases, outs = tp2
    c = cases["int4"]
    res = same_on_ranks(outs, "int4")
    je = jax_engine(c)
    want = [r.tokens for r in je.generate_beam_search(
        PROMPTS[1], 6, beam_size=3, return_all_beams=True)]
    assert res[3] == want
    close(res[4], je.compute_logprobs(TOKENS[1].tolist()))


def test_tp2_stream_matches_jax_mesh(tp2):
    cases, outs = tp2
    want = jax_batch(cases["int4"], [PROMPTS[0]], 10)[0][len(PROMPTS[0]):]
    assert same_on_ranks(outs, "int4")[5] == want


def test_tp2_checkpoint_restores_each_ranks_slice(tp2):
    """load_checkpoint(mesh=) gives each rank exactly shard_params's
    slices and the config, and the restored engine JAX's tokens."""
    cases, outs = tp2
    same, cfg_ok, toks = same_on_ranks(outs, "int4")[6]
    assert same and cfg_ok
    assert toks == jax_batch(cases["int4"], PROMPTS, 8)


def test_tp2_collectives_ran(tp2):
    _, outs = tp2
    assert all(o["int4"][7] > 0 for o in outs)
    assert sorted(o["__coords__"] for o in outs) == [(0, 0), (0, 1)]


# -- (2, 1) data and (2, 2) data x tp ------------------------------------

DP_PROMPTS = [[1, 5, 7, 9], [3, 4, 5, 6, 7, 8, 9], [2, 4], [8, 8, 8, 1, 2]]
# the decode loops a sampled data-split batch runs
DP_SAMPLED = {"scan": {}, "host": {"decode_loop": "host"},
              "nocache": {"use_cache": False}}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    c = case("int4", *llama_case("int4", quant=True),
             [("batch", DP_PROMPTS, 10), ("batch", DP_PROMPTS[:3], 10)]
             + [("sample_vs_one", DP_PROMPTS, 8, icfg) for icfg in
                DP_SAMPLED.values()])
    runs = {}
    for shape in ((2, 1), (2, 2)):
        d = str(tmp_path_factory.mktemp(f"mesh{shape[0]}{shape[1]}"))
        runs[shape] = spawn(d, shape[0] * shape[1], shape, [c])
    return c, runs


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["dp2", "dp2xtp2"])
@pytest.mark.parametrize("rows", [4, 3], ids=["split", "replicated"])
def test_data_parallel_matches_jax_mesh(mesh_runs, shape, rows):
    """Four rows split over the data axis (each data rank its two, the
    results gathered on every rank); three do not divide and run whole
    on each data rank, as JAX's shard_cache replicates them."""
    c, runs = mesh_runs
    got = same_on_ranks(runs[shape], "int4")[0 if rows == 4 else 1]
    assert got == jax_batch(c, DP_PROMPTS[:rows], 10, shape)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["dp2", "dp2xtp2"])
@pytest.mark.parametrize("loop", list(DP_SAMPLED))
def test_data_parallel_samples_equal_one_rank(mesh_runs, shape, loop):
    """At temperature 0.9 each data rank draws the whole batch's noise and
    takes its rows', and runs as many steps: the gathered tokens are
    those of one process running the whole batch (no data rank repeats
    another's random stream)."""
    _, runs = mesh_runs
    on_mesh, alone = same_on_ranks(runs[shape], "int4")[
        2 + list(DP_SAMPLED).index(loop)]
    assert on_mesh == alone
    assert len({tuple(r[len(p):]) for r, p in zip(alone, DP_PROMPTS)}) > 1
