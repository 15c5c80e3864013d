"""The port's LoRA adapters (loader/lora.py, the runtime path in
models/llama.py) against the JAX package on the CPU.

Adapters are PEFT files (adapter_model.safetensors + adapter_config.json)
written in the test, and one saved by peft itself (skipped without
peft, as the JAX package's test_lora.py). Held: the loaded slots bit for
bit, f32 logits within 1e-4 of JAX's on fp and int4 bases (fused by the
engine's prepare_params or not), greedy trajectories token for token,
merge and strip, the golden PEFT logits, load_engine with an adapter.

One difference is pinned on purpose: the JAX package's paged forwards
add the q/k/v and gate/up updates but not wo's or w_down's, so JAX
serves a LoRA model through its paged scheduler differently from its
own forward. The port applies the adapter wherever JAX's forward of the
family applies it, on every path; its MoE layer adds only q/k/v updates,
as JAX's MoE does.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turboinfer_tpu import config as jconfig
from turboinfer_tpu.loader import loader as jloader
from turboinfer_tpu.loader import lora as jlora
from turboinfer_tpu.loader import tinq as jtinq
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.models import moe as jmoe
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu.utils.errors import ModelFormatError as JModelFormatError
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.loader import loader as tloader
from turboinfer_tpu_torch.loader import lora as tlora
from turboinfer_tpu_torch.loader import safetensors as tst
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.models import moe as tmoe
from turboinfer_tpu_torch.utils.errors import ModelFormatError

from test_torch_loader import assert_same_params, jax_to_numpy

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
TINY = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, max_seq_len=64)
MOE = dict(TINY, num_experts=4, experts_per_token=2, intermediate_size=128,
           architecture="mixtral", name="tiny-mixtral")
MODULES = {"q_proj": ("self_attn", "q_dim", "hidden_size"),
           "k_proj": ("self_attn", "kv_dim", "hidden_size"),
           "v_proj": ("self_attn", "kv_dim", "hidden_size"),
           "o_proj": ("self_attn", "hidden_size", "q_dim"),
           "gate_proj": ("mlp", "ffn_dim", "hidden_size"),
           "up_proj": ("mlp", "ffn_dim", "hidden_size"),
           "down_proj": ("mlp", "hidden_size", "ffn_dim")}
TOKENS = [[3, 17, 250, 9, 41, 8, 120]]


def write_adapter(path, cfg, r=4, alpha=8.0, rslora=False,
                  modules=tuple(MODULES), layers=None, seed=0,
                  dtype=np.float32):
    """A PEFT adapter directory: lora_A [r, in] / lora_B [out, r] for
    each module of each layer (layers: default all)."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    t = {}
    for i in (range(cfg.num_layers) if layers is None else layers):
        for m in modules:
            part, out_f, in_f = MODULES[m]
            o, n = getattr(cfg, out_f), getattr(cfg, in_f)
            pre = f"base_model.model.model.layers.{i}.{part}.{m}"
            t[f"{pre}.lora_A.weight"] = (0.1 * rng.normal(size=(r, n))
                                         ).astype(dtype)
            t[f"{pre}.lora_B.weight"] = (0.1 * rng.normal(size=(o, r))
                                         ).astype(dtype)
    tst.write_safetensors(os.path.join(path, "adapter_model.safetensors"), t)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "use_rslora": rslora,
                   "target_modules": list(modules)}, f)
    return path


_M = {}


def models(kind="llama", quant=False):
    """(JAX config, JAX params, port config, port params), f32, int4
    g=32 (the JAX quantizer's output, bridged) with quant."""
    if (kind, quant) not in _M:
        kw = MOE if kind == "moe" else TINY
        jcfg = jconfig.ModelConfig(dtype=jnp.float32, **kw)
        jp = (jmoe if kind == "moe" else jllama).init_params(
            jax.random.PRNGKey(7), jcfg)
        if quant:
            jp = jquantizer.quantize_params(jp, jconfig.QuantizationConfig(
                type=jconfig.QuantType.INT4, group_size=32))
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        _M[kind, quant] = (jcfg, jp, tcfg, bridge.params_from_numpy(
            jax_to_numpy(jp), device="cpu"))
    return _M[kind, quant]


def with_adapter(tmp_path, kind="llama", quant=False, **kw):
    jcfg, jp, tcfg, tp = models(kind, quant)
    d = write_adapter(str(tmp_path / "adapter"), jcfg, **kw)
    jad = jlora.load_lora(d, jcfg, dtype=jnp.float32)
    tad = tlora.load_lora(d, tcfg, dtype=torch.float32, device="cpu")
    return (jcfg, jlora.apply_lora(jp, jad), tcfg,
            tlora.apply_lora(tp, tad), d)


def nocache(mod, params, cfg, tokens=TOKENS):
    if mod in (tllama, tmoe):
        return mod.forward_no_cache(params, cfg, torch.tensor(
            tokens, dtype=torch.int32)).numpy()
    return np.asarray(mod.forward_no_cache(params, cfg,
                                           jnp.asarray(tokens, jnp.int32)))


@pytest.mark.parametrize("rslora", [False, True], ids=["lora", "rslora"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_load_lora_as_jax(tmp_path, rslora, dtype):
    """Stacked [L, in, r] / [L, r, out] slots with alpha/r (rsLoRA:
    alpha/sqrt(r)) folded into B, bit for bit; untargeted layers zero."""
    jcfg, _, tcfg, _ = models()
    d = write_adapter(str(tmp_path / "a"), jcfg, r=4, alpha=16.0,
                      rslora=rslora, layers=[1], dtype=dtype,
                      modules=("q_proj", "o_proj", "down_proj"))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = tlora.load_lora(d, tcfg, dtype=tdt, device="cpu")
        want = jlora.load_lora(d, jcfg, dtype=jdt)
        assert_same_params(got, want)
    assert got["lora_wq_a"].shape == (2, 128, 4)
    assert not got["lora_wo_b"][0].any()
    # the file path entry point reads the config beside it
    f = os.path.join(d, "adapter_model.safetensors")
    assert_same_params(tlora.load_lora(f, tcfg, device="cpu"),
                       jlora.load_lora(f, jcfg))


def test_lora_errors(tmp_path):
    jcfg, _, tcfg, _ = models()
    bad = {"half": {"base_model.model.model.layers.0.self_attn.q_proj."
                    "lora_A.weight": np.zeros((4, 128), np.float32)},
           "layer": {f"base_model.model.model.layers.5.self_attn.q_proj."
                     f"lora_{w}.weight": np.zeros(s, np.float32)
                     for w, s in (("A", (4, 128)), ("B", (128, 4)))},
           "none": {"something.else": np.zeros(3, np.float32)}}
    for name, tensors in bad.items():
        path = str(tmp_path / f"{name}.safetensors")
        tst.write_safetensors(path, tensors)
        with pytest.raises(ModelFormatError):
            tlora.load_lora(path, tcfg, device="cpu")
        with pytest.raises(JModelFormatError):
            jlora.load_lora(path, jcfg)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
def test_lora_forward_as_jax(tmp_path, quant):
    """Every slot adapted on an fp and an int4 base: the port's forward
    (fresh prefill, a decode step; unfused and fused by prepare_params)
    within 1e-4 of JAX's, and the adapter matters."""
    jcfg, jp, tcfg, tp = with_adapter(tmp_path, quant=quant)[:4]
    want = nocache(jllama, jp, jcfg)
    np.testing.assert_allclose(nocache(tllama, tp, tcfg), want,
                               atol=LOGIT_ATOL, rtol=1e-4)
    fused = prepare_params(tp)
    assert "wqkv" in fused["layers"] and "lora_wq_a" in fused["layers"]
    np.testing.assert_allclose(nocache(tllama, fused, tcfg), want,
                               atol=LOGIT_ATOL, rtol=1e-4)
    base = nocache(jllama, models(quant=quant)[1], jcfg)
    assert np.abs(base - want).max() > 1e-2
    # decode: a prefill of 6 tokens and one step over the cache
    cache = tllama.init_cache(tcfg, 1, device="cpu")
    tok = torch.tensor(TOKENS, dtype=torch.int32)
    _, cache = tllama.forward(fused, tcfg, tok[:, :6], cache,
                              fresh_prefill=True)
    step, _ = tllama.forward(fused, tcfg, tok[:, 6:], cache)
    np.testing.assert_allclose(step[:, 0].numpy(), want[:, 6],
                               atol=LOGIT_ATOL, rtol=1e-4)


def test_prepare_params_keeps_adapters_unfused_in_f32(tmp_path):
    """The engine's prepare_params fuses the base projections, keeps the
    lora_* slots as they are named and casts them once to the f32 that
    add_lora multiplies in (exact from bf16): the same logits."""
    jcfg, jp, tcfg, tp = models()
    d = write_adapter(str(tmp_path / "a"), jcfg)
    ad = tlora.load_lora(d, tcfg, dtype=torch.bfloat16, device="cpu")
    p = tlora.apply_lora(tp, ad)
    fused = prepare_params(p)
    lw = fused["layers"]
    assert "wqkv" in lw and "w_gateup" in lw and "wq" not in lw
    for k, v in ad.items():
        assert lw[k].dtype == torch.float32
        assert torch.equal(lw[k], v.to(torch.float32))
    np.testing.assert_allclose(nocache(tllama, fused, tcfg),
                               nocache(tllama, p, tcfg), atol=LOGIT_ATOL,
                               rtol=1e-4)


def test_lora_generate_batch_as_jax(tmp_path):
    """int4 base + adapter: the port engine's greedy trajectories equal
    the JAX engine's, token for token."""
    from turboinfer_tpu.engine.engine import InferenceEngine as JEngine
    jcfg, jp, tcfg, tp = with_adapter(tmp_path, quant=True)[:4]
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1)
    prompts = [[1, 5, 9, 33, 7], [250, 2]]
    got = InferenceEngine(tp, tcfg, tconfig.InferenceConfig(**icfg),
                          device="cpu").generate_batch(prompts, 12)
    want = JEngine(jp, jcfg, jconfig.InferenceConfig(**icfg)
                   ).generate_batch(prompts, 12)
    assert [r.tokens for r in got] == [r.tokens for r in want]


def _paged_chain(mod, forward_paged_decode, params, cfg, tokens):
    """Decode `tokens` [S] one at a time through forward_paged_decode over
    a fresh pool (B=1, 8-token pages) -> the logits of every step."""
    L, Hkv, D = cfg.num_layers, cfg.kv_heads, cfg.head_dim_
    shape = (L, 4, Hkv, 8, D)
    if mod is torch:
        kp, vp = torch.zeros(shape), torch.zeros(shape)
        table = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    else:
        kp, vp = jnp.zeros(shape), jnp.zeros(shape)
        table = jnp.asarray([[1, 2, 3]], jnp.int32)
    out = []
    for s, t in enumerate(tokens):
        tok = mod.tensor([t], dtype=torch.int32) if mod is torch else \
            jnp.asarray([t], jnp.int32)
        n = mod.tensor([s], dtype=torch.int32) if mod is torch else \
            jnp.asarray([s], jnp.int32)
        lg, kp, vp = forward_paged_decode(params, cfg, tok, kp, vp, table, n)
        out.append(np.asarray(lg)[0])
    return np.stack(out)


def test_paged_lora_port_applies_everywhere_jax_does_not(tmp_path):
    """The pinned difference: JAX's paged decode adds the q/k/v and
    gate/up updates but not wo's and w_down's (it equals its own forward
    with those two stripped, and differs from its forward); the port's
    paged decode equals the port's and JAX's forward."""
    jcfg, jp, tcfg, tp = with_adapter(tmp_path)[:4]
    toks = TOKENS[0]
    want = nocache(jllama, jp, jcfg)[0]
    jpaged = _paged_chain(jnp, jllama.forward_paged_decode, jp, jcfg, toks)
    tpaged = _paged_chain(torch, tllama.forward_paged_decode, tp, tcfg, toks)
    np.testing.assert_allclose(tpaged, want, atol=LOGIT_ATOL, rtol=1e-4)
    partial = {**jp, "layers": {k: v for k, v in jp["layers"].items()
                                if not k.startswith(("lora_wo_",
                                                     "lora_w_down_"))}}
    np.testing.assert_allclose(jpaged, nocache(jllama, partial, jcfg)[0],
                               atol=LOGIT_ATOL, rtol=1e-4)
    assert np.abs(jpaged - want).max() > 1e-2


def test_paged_scheduler_with_lora_matches_generate_batch(tmp_path):
    """The port serves an adapter through the paged scheduler exactly as
    generate_batch runs it (greedy, token for token)."""
    _, _, tcfg, tp = with_adapter(tmp_path, quant=True)[:4]
    icfg = tconfig.InferenceConfig(max_seq_len=64, temperature=0.0,
                                   eos_token_id=-1)
    prompts = [[1, 5, 9, 33, 7], [250, 2, 11]]
    want = [r.tokens for r in InferenceEngine(
        tp, tcfg, icfg, device="cpu").generate_batch(prompts, 10)]
    sched = PagedContinuousScheduler(tp, tcfg, icfg, batch_slots=2,
                                     page_size=8, device="cpu")
    ids = [sched.submit(p, 10) for p in prompts]
    res = sched.run()
    assert [res[i].tokens for i in ids] == want


def test_moe_lora_adds_only_qkv_as_jax(tmp_path):
    """A MoE model with every adapter slot attached (wo's and the dense
    FFN's included): its forward equals JAX's MoE forward, which adds
    only the q/k/v updates."""
    jcfg, jp, tcfg, tp = models("moe")
    dense = tconfig.ModelConfig(dtype=torch.float32, **TINY)
    d = write_adapter(str(tmp_path / "a"), dense)
    ad = jlora.load_lora(d, jcfg, dtype=jnp.float32)
    jpl = jlora.apply_lora(jp, ad)
    tpl = tlora.apply_lora(tp, tlora.load_lora(d, tcfg, device="cpu"))
    want = nocache(jmoe, jpl, jcfg)
    np.testing.assert_allclose(nocache(tmoe, tpl, tcfg), want,
                               atol=LOGIT_ATOL, rtol=1e-4)
    qkv_only = {**tp, "layers": {**tp["layers"], **{
        k: v for k, v in tpl["layers"].items()
        if k.startswith(("lora_wq", "lora_wk", "lora_wv"))}}}
    np.testing.assert_allclose(nocache(tmoe, qkv_only, tcfg), want,
                               atol=LOGIT_ATOL, rtol=1e-4)
    assert np.abs(nocache(jmoe, jp, jcfg) - want).max() > 1e-2


def test_merge_and_strip_as_jax(tmp_path):
    jcfg, jpl, tcfg, tpl, d = with_adapter(tmp_path)
    tad = tlora.load_lora(d, tcfg, dtype=torch.float32, device="cpu")
    jad = jlora.load_lora(d, jcfg, dtype=jnp.float32)
    merged = tlora.merge_lora(models()[3], tad)
    jmerged = jlora.merge_lora(models()[1], jad)
    for k in ("wq", "wo", "w_down"):
        np.testing.assert_allclose(merged["layers"][k].numpy(),
                                   np.asarray(jmerged["layers"][k]),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(nocache(tllama, merged, tcfg),
                               nocache(jllama, jpl, jcfg), atol=LOGIT_ATOL,
                               rtol=1e-4)
    assert_same_params(tlora.strip_lora(tpl), models()[1])
    with pytest.raises(ModelFormatError, match="quantized"):
        tlora.merge_lora(models(quant=True)[3], tad)


def test_load_engine_with_lora_as_jax(tmp_path):
    """load_engine(.tinq, lora=dir): the int4 base from a JAX-written
    TINQ file and the adapter, greedy tokens equal JAX's load_engine."""
    jcfg, jp, _, _ = models(quant=True)
    d = write_adapter(str(tmp_path / "a"), jcfg, seed=3)
    path = str(tmp_path / "base.tinq")
    jtinq.save(path, jp, jcfg)
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1)
    eng = tloader.load_engine(path, tconfig.InferenceConfig(**icfg),
                              lora=d, device="cpu")
    jeng = jloader.load_engine(path, jconfig.InferenceConfig(**icfg),
                               lora=d)
    assert "lora_w_down_b" in eng.params["layers"]
    prompts = [[1, 5, 9], [44, 45, 46, 47]]
    assert [r.tokens for r in eng.generate_batch(prompts, 8)] == \
        [r.tokens for r in jeng.generate_batch(prompts, 8)]


@pytest.fixture(scope="module")
def peft_adapter(tmp_path_factory):
    """A tiny HF llama under a PEFT adapter saved by peft itself, its
    golden logits, and its base weights as the JAX loader maps them."""
    transformers = pytest.importorskip("transformers")
    peft = pytest.importorskip("peft")
    from turboinfer_tpu.loader import mapping as jmapping
    torch.manual_seed(11)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, attn_implementation="eager")
    model = peft.get_peft_model(
        transformers.LlamaForCausalLM(hf_cfg),
        peft.LoraConfig(r=4, lora_alpha=8, init_lora_weights=False,
                        target_modules=list(MODULES)))
    d = str(tmp_path_factory.mktemp("peft"))
    model.save_pretrained(d)
    tokens = np.random.default_rng(3).integers(0, 256, size=(2, 12))
    model.eval()
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.float().numpy()
    sd = {k.replace("base_model.model.", "").replace(".base_layer", ""):
          v.float().numpy() for k, v in
          model.get_base_model().state_dict().items() if "lora_" not in k}
    jcfg = jmapping.config_from_hf_dict(hf_cfg.to_dict(), dtype=jnp.float32)
    jp = jmapping.assemble_params(lambda n: sd[n], list(sd), jcfg,
                                  dtype=jnp.float32)
    return d, jcfg, jp, tokens, want


def test_lora_golden_vs_peft(peft_adapter):
    """peft's own adapter file on its base: the port's logits within
    3e-3 of PEFT's (the JAX package's golden tolerance) and within 1e-4
    of JAX's."""
    d, jcfg, jp, tokens, want = peft_adapter
    tcfg = tconfig.ModelConfig(**{**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "num_kv_heads", "intermediate_size", "rope_theta", "rms_norm_eps",
        "max_seq_len", "architecture")}, "dtype": torch.float32})
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    tpl = tlora.apply_lora(tp, tlora.load_lora(d, tcfg, device="cpu"))
    got = nocache(tllama, tpl, tcfg, tokens.tolist())
    np.testing.assert_allclose(got, want, atol=3e-3, rtol=3e-3)
    jpl = jlora.apply_lora(jp, jlora.load_lora(d, jcfg, dtype=jnp.float32))
    np.testing.assert_allclose(got, nocache(jllama, jpl, jcfg,
                                            tokens.tolist()),
                               atol=LOGIT_ATOL, rtol=1e-4)
