"""The port's weights in and out (turboinfer_tpu_torch/loader, native.py,
tokenizer/bpe.py, the qtensor and quantizer remainders) against the JAX
package on the CPU.

Files go both ways: written by the JAX package's writers and loaded by
the port, and written by the port's writers and loaded by the JAX
package. The loaded parameters are compared through the numpy bridge
bit for bit (f32 models; bf16 through the same f32 -> bf16 cast), the
writers' files byte for byte where both packages write the same format
(safetensors, GGUF, TINQ), and loaded models by f32 logits within 1e-4
and greedy trajectories token for token. Also: every GGML block type
through the port's native dequantizer, its numpy forms and the JAX
package's; the config mappings (GGUF metadata, HF config.json, the TINQ
dict) field for field; checkpoint directories; the tokenizers.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from turboinfer_tpu import config as jconfig
from turboinfer_tpu.core import qtensor as jqt
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.loader import ckpt as jckpt
from turboinfer_tpu.loader import gguf as jgguf
from turboinfer_tpu.loader import loader as jloader
from turboinfer_tpu.loader import mapping as jmapping
from turboinfer_tpu.loader import safetensors as jst
from turboinfer_tpu.loader import tinq as jtinq
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.models import moe as jmoe
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu.tokenizer import bpe as jbpe
from turboinfer_tpu_torch import bridge, native
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.core import qtensor as tqt
from turboinfer_tpu_torch.loader import ckpt as tckpt
from turboinfer_tpu_torch.loader import gguf as tgguf
from turboinfer_tpu_torch.loader import loader as tloader
from turboinfer_tpu_torch.loader import mapping as tmapping
from turboinfer_tpu_torch.loader import safetensors as tst
from turboinfer_tpu_torch.loader import tinq as ttinq
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.quant import quantizer as tquantizer
from turboinfer_tpu_torch.tokenizer import bpe as tbpe
from turboinfer_tpu_torch.utils.errors import ModelFormatError

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
TINY = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, max_seq_len=64)
TOKENS = [[1, 5, 42, 7, 99, 3]]

_P = {}


def jax_to_numpy(tree):
    """The JAX half of the bridge: a JAX param tree as numpy."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data),
                "scales": np.asarray(tree.scales),
                "zero_points": None if tree.zero_points is None
                else np.asarray(tree.zero_points), "bits": tree.bits,
                "group_size": tree.group_size, "shape": tuple(tree.shape)}
    if isinstance(tree, JQEmbed):
        return {"data": np.asarray(tree.data),
                "row_scales": np.asarray(tree.scales)}
    return np.asarray(tree)


def _bits(a):
    """An array as comparable bits: bf16 as f32 (exact), the rest as is."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def assert_same_params(port_params, jax_params):
    """Port params (torch) and JAX params bit for bit, leaf for leaf."""
    got, want = bridge.to_numpy(port_params), jax_to_numpy(jax_params)

    def walk(g, w, path):
        if isinstance(w, dict):
            assert isinstance(g, dict) and set(g) == set(w), (path, g, w)
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif w is None or isinstance(w, (int, tuple)):
            assert g == w, path
        else:
            g, w = _bits(g), _bits(w)
            assert g.shape == w.shape, (path, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=path)
    walk(got, want, "")


def tiny(kind="llama"):
    """(JAX config, JAX f32 params, port config) of a tiny model."""
    if kind not in _P:
        kw = dict(TINY)
        if kind == "moe":
            kw.update(num_experts=4, experts_per_token=2,
                      intermediate_size=128, architecture="mixtral",
                      name="tiny-mixtral")
        jcfg = jconfig.ModelConfig(dtype=jnp.float32, **kw)
        jm = jmoe if kind == "moe" else jllama
        jp = jm.init_params(jax.random.PRNGKey(3), jcfg)
        _P[kind] = (jcfg, jp, tconfig.ModelConfig(dtype=torch.float32, **kw))
    return _P[kind]


def port_logits(params, cfg, tokens=TOKENS):
    return tllama.forward_no_cache(
        params, cfg, torch.tensor(tokens, dtype=torch.int32)).numpy()


def jax_logits(params, cfg, tokens=TOKENS):
    return np.asarray(jllama.forward_no_cache(
        params, cfg, jnp.asarray(tokens, jnp.int32)))


# -- file writers of the JAX layout -----------------------------------------

_HF = dict(attn_norm="model.layers.{i}.input_layernorm.weight",
           ffn_norm="model.layers.{i}.post_attention_layernorm.weight",
           wq="model.layers.{i}.self_attn.q_proj.weight",
           wk="model.layers.{i}.self_attn.k_proj.weight",
           wv="model.layers.{i}.self_attn.v_proj.weight",
           wo="model.layers.{i}.self_attn.o_proj.weight",
           w_gate="model.layers.{i}.mlp.gate_proj.weight",
           w_up="model.layers.{i}.mlp.up_proj.weight",
           w_down="model.layers.{i}.mlp.down_proj.weight")
_GGUF = dict(attn_norm="blk.{i}.attn_norm.weight",
             ffn_norm="blk.{i}.ffn_norm.weight",
             wq="blk.{i}.attn_q.weight", wk="blk.{i}.attn_k.weight",
             wv="blk.{i}.attn_v.weight", wo="blk.{i}.attn_output.weight",
             w_gate="blk.{i}.ffn_gate.weight", w_up="blk.{i}.ffn_up.weight",
             w_down="blk.{i}.ffn_down.weight")


def named_tensors(jp, cfg, names="hf", fused=False):
    """JAX params -> a name -> f32 numpy dict in file layout ([out, in]);
    fused: Phi-3's qkv_proj / gate_up_proj (HF) or attn_qkv and a
    double-width ffn_up (GGUF)."""
    layers = jp["layers"]
    fmt = dict(_HF if names == "hf" else _GGUF)
    if names == "hf":
        t = {"model.embed_tokens.weight": np.asarray(jp["embed"]),
             "model.norm.weight": np.asarray(jp["final_norm"]),
             "lm_head.weight": np.asarray(jp["lm_head"]).T}
    else:
        t = {"token_embd.weight": np.asarray(jp["embed"]),
             "output_norm.weight": np.asarray(jp["final_norm"]),
             "output.weight": np.asarray(jp["lm_head"]).T}
    for i in range(cfg.num_layers):
        row = {s: np.asarray(layers[s][i], np.float32) for s in fmt}
        for s in fmt:
            if s not in ("attn_norm", "ffn_norm"):
                row[s] = row[s].T
        if fused:
            qkv = np.concatenate([row.pop(s) for s in ("wq", "wk", "wv")])
            gu = np.concatenate([row.pop("w_gate"), row.pop("w_up")])
            if names == "hf":
                t[f"model.layers.{i}.self_attn.qkv_proj.weight"] = qkv
                t[f"model.layers.{i}.mlp.gate_up_proj.weight"] = gu
            else:
                t[f"blk.{i}.attn_qkv.weight"] = qkv
                t[f"blk.{i}.ffn_up.weight"] = gu
        for s, arr in row.items():
            t[fmt[s].format(i=i)] = np.ascontiguousarray(arr)
    return t


def hf_config(cfg, model_type="llama"):
    return {"model_type": model_type, "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.kv_heads,
            "intermediate_size": cfg.ffn_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len}


def gguf_metadata(cfg, arch="llama"):
    return {"general.architecture": arch, "general.name": "tiny-export",
            f"{arch}.embedding_length": cfg.hidden_size,
            f"{arch}.block_count": cfg.num_layers,
            f"{arch}.attention.head_count": cfg.num_heads,
            f"{arch}.attention.head_count_kv": cfg.kv_heads,
            f"{arch}.feed_forward_length": cfg.ffn_dim,
            f"{arch}.rope.freq_base": cfg.rope_theta,
            f"{arch}.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
            f"{arch}.context_length": cfg.max_seq_len,
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"]
            + [f"tok{i}" for i in range(cfg.vocab_size - 3)],
            "tokenizer.ggml.scores": [0.0] * cfg.vocab_size,
            "tokenizer.ggml.eos_token_id": 2}


def write_hf_dir(path, tensors, cfg_dict, shards=1):
    """An HF checkpoint directory through the JAX writers: one
    model.safetensors, or `shards` files with an index."""
    os.makedirs(path, exist_ok=True)
    names = sorted(tensors)
    if shards == 1:
        jst.write_safetensors(os.path.join(path, "model.safetensors"),
                              tensors)
    else:
        weight_map = {}
        for s in range(shards):
            fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
            keys = names[s::shards]
            jst.write_safetensors(os.path.join(path, fname),
                                  {k: tensors[k] for k in keys})
            weight_map.update({k: fname for k in keys})
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f)


# -- safetensors ------------------------------------------------------------

def _st_arrays():
    rng = np.random.default_rng(0)
    return {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "f16": rng.normal(size=(4,)).astype(np.float16),
            "i8": rng.integers(-128, 127, size=(2, 3), dtype=np.int8),
            "u8": rng.integers(0, 255, size=(7,), dtype=np.uint8),
            "i64": np.arange(3, dtype=np.int64),
            "bf16": rng.normal(size=(2, 6)).astype(ml_dtypes.bfloat16),
            "scalar": np.float32(2.5)}


def test_safetensors_files_are_byte_identical(tmp_path):
    """The port's writer (numpy arrays, and torch tensors with bf16 as
    BF16) writes the JAX writer's bytes, metadata included."""
    arrays = _st_arrays()
    md = {"format": "pt", "n": 3}
    jst.write_safetensors(str(tmp_path / "j.safetensors"), arrays, md)
    tst.write_safetensors(str(tmp_path / "t.safetensors"), arrays, md)
    as_torch = {k: (bridge.tensor_from_numpy(v, "cpu")) for k, v in
                arrays.items()}
    tst.write_safetensors(str(tmp_path / "tt.safetensors"), as_torch, md)
    want = (tmp_path / "j.safetensors").read_bytes()
    assert (tmp_path / "t.safetensors").read_bytes() == want
    assert (tmp_path / "tt.safetensors").read_bytes() == want


def test_safetensors_read_both_ways(tmp_path):
    arrays = _st_arrays()
    jst.write_safetensors(str(tmp_path / "j.safetensors"), arrays)
    with tst.read_safetensors(str(tmp_path / "j.safetensors")) as sf, \
            jst.read_safetensors(str(tmp_path / "j.safetensors")) as jf:
        assert list(sf.keys()) == list(jf.keys())
        for k in arrays:
            np.testing.assert_array_equal(sf.tensor(k), jf.tensor(k))
            t = sf.torch_tensor(k)
            np.testing.assert_array_equal(_bits(bridge.to_numpy(t)),
                                          _bits(arrays[k]))
        assert sf.torch_tensor("bf16").dtype == torch.bfloat16


def test_safetensors_size_validation(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    tst.write_safetensors(path, {"x": np.zeros(4, np.float32)})
    raw = bytearray(open(path, "rb").read())
    open(path, "wb").write(bytes(raw[:-4]))        # truncate the data
    for mod in (tst, jst):
        with pytest.raises(ValueError, match="past end of file"):
            mod.read_safetensors(path)


# -- GGUF container, native library -----------------------------------------

def _gguf_payload():
    rng = np.random.default_rng(1)
    md = {"general.architecture": "llama", "general.name": "unit",
          "llama.embedding_length": 8, "llama.rope.freq_base": 10000.0,
          "some.flag": True, "neg": -3, "big": 2 ** 40,
          "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "he", "llo"],
          "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0, -2.0],
          "ids.array": [1, 2, 3, 4], "general.alignment": 64}
    tensors = {"token_embd.weight": rng.normal(size=(5, 8)).astype(np.float32),
               "half.weight": rng.normal(size=(4, 8)).astype(np.float16),
               "vec": np.ones(3, np.float32)}
    return md, tensors


def test_gguf_files_are_byte_identical_and_read_both_ways(tmp_path):
    md, tensors = _gguf_payload()
    jgguf.write_gguf(str(tmp_path / "j.gguf"), md, tensors)
    tgguf.write_gguf(str(tmp_path / "t.gguf"), md, tensors)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    with tgguf.read_gguf(str(tmp_path / "t.gguf")) as tf, \
            jgguf.read_gguf(str(tmp_path / "j.gguf")) as jf:
        assert tf.metadata == jf.metadata
        assert tf.data_start == jf.data_start and tf.alignment == 64
        assert {n: (i.dims, i.ggml_type, i.offset)
                for n, i in tf.tensors.items()} == \
            {n: (i.dims, i.ggml_type, i.offset)
             for n, i in jf.tensors.items()}
        for n in tensors:
            np.testing.assert_array_equal(tf.tensor(n), jf.tensor(n))


def test_gguf_index_native_equals_python(tmp_path, monkeypatch):
    """The native index parse and the Python one read the same file the
    same way; the port's native library is built under its own _build/
    directory, never into native/."""
    md, tensors = _gguf_payload()
    path = str(tmp_path / "m.gguf")
    tgguf.write_gguf(path, md, tensors)
    assert native.available(), native.last_error()
    lib = native._lib_path(native._flags)
    assert lib.exists()
    assert lib.parent.parent.name == "_build"
    assert lib.parent.parent.parent.name == "turboinfer_tpu_torch"
    with tgguf.read_gguf(path) as a:
        got = (a.metadata, a.data_start,
               {n: (i.dims, i.ggml_type, i.offset)
                for n, i in a.tensors.items()})
    monkeypatch.setenv("TURBOINFER_NO_NATIVE", "1")
    with tgguf.read_gguf(path) as b:
        want = (b.metadata, b.data_start,
                {n: (i.dims, i.ggml_type, i.offset)
                 for n, i in b.tensors.items()})
    assert got == want


def test_native_builds_without_openmp(tmp_path, monkeypatch):
    """Where g++ has no OpenMP runtime (the GPU machine's has none), the
    library builds serially and dequantizes as the numpy forms do."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "OPENMP", "-fno-such-openmp-flag")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    assert native.available(), native.last_error()
    assert not native.openmp()
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 256, size=(64, 144), dtype=np.uint8)
    blocks[:, 0:4] = rng.normal(scale=0.05, size=(64, 2)).astype(
        np.float16).view(np.uint8)
    raw = blocks.reshape(-1)
    np.testing.assert_array_equal(
        native.ggml_dequant(raw, tgguf.GGML_Q4_K, 64 * 256),
        tgguf.dequantize_ggml_numpy(raw, tgguf.GGML_Q4_K, 64 * 256))


def test_gguf_bad_magic(tmp_path):
    path = str(tmp_path / "bad.gguf")
    open(path, "wb").write(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ModelFormatError):
        with tgguf.read_gguf(path):
            pass


_GGML_TYPES = sorted(tgguf._BLOCK_LAYOUT)


@pytest.mark.parametrize("ggml_type", _GGML_TYPES,
                         ids=[tgguf.GGML_TYPE_NAMES[t] for t in _GGML_TYPES])
def test_dequant_native_numpy_and_jax_agree(ggml_type):
    """Random blocks of every GGML type (fp16 scale fields finite):
    the native dequantizer, the port's numpy forms and the JAX package
    give the same f32 values, bit for bit."""
    be, bb = tgguf._BLOCK_LAYOUT[ggml_type]
    nb = 64 if be > 1 else 2048
    rng = np.random.default_rng(ggml_type)
    raw = rng.integers(0, 256, size=nb * bb, dtype=np.uint8)
    if ggml_type in (tgguf.GGML_F32, tgguf.GGML_F64, tgguf.GGML_F16,
                     tgguf.GGML_BF16):
        dt = {tgguf.GGML_F32: np.float32, tgguf.GGML_F64: np.float64,
              tgguf.GGML_F16: np.float16,
              tgguf.GGML_BF16: ml_dtypes.bfloat16}[ggml_type]
        raw = rng.normal(size=nb * bb // np.dtype(dt).itemsize).astype(
            dt).view(np.uint8)
    elif be > 1:
        blocks = raw.reshape(nb, bb)
        # the fp16 d/dmin fields of each layout, as finite halves
        fields = {tgguf.GGML_Q2_K: (80, 82), tgguf.GGML_Q3_K: (108,),
                  tgguf.GGML_Q6_K: (208,), tgguf.GGML_Q8_K: ()}.get(
                      ggml_type, (0, 2) if ggml_type in (
                          tgguf.GGML_Q4_1, tgguf.GGML_Q5_1,
                          tgguf.GGML_Q4_K, tgguf.GGML_Q5_K) else (0,))
        for off in fields:
            blocks[:, off:off + 2] = rng.normal(scale=0.05, size=nb).astype(
                np.float16).view(np.uint8).reshape(nb, 2)
        if ggml_type == tgguf.GGML_Q8_K:
            blocks[:, 0:4] = rng.normal(scale=0.05, size=nb).astype(
                np.float32).view(np.uint8).reshape(nb, 4)
    n = nb * be
    got = native.ggml_dequant(raw, ggml_type, n)
    plain = tgguf.dequantize_ggml_numpy(raw, ggml_type, n)
    want = np.asarray(jgguf.dequantize_ggml(raw, ggml_type, n))
    assert np.isfinite(plain).all()
    np.testing.assert_array_equal(plain, want)
    if got is not None or be > 1:
        np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(tgguf.dequantize_ggml(raw, ggml_type, n),
                                  plain)


def test_unsupported_ggml_type_raises():
    with pytest.raises(ModelFormatError, match="unsupported"):
        tgguf.dequantize_ggml(np.zeros(64, np.uint8), 99, 32)
    with pytest.raises(ModelFormatError):
        tgguf.tensor_nbytes(16, 256)       # IQ2_XXS: not in the layout


# -- model files: the JAX package's writers -> the port's loader ------------

@pytest.mark.parametrize("names", ["gguf", "hf"])
def test_gguf_model_loads_as_jax_loads_it(tmp_path, names):
    """A tiny llama written as GGUF by the JAX writer (llama.cpp or HF
    tensor names): the port's params equal the JAX loader's bit for bit
    (f32), the logits the original model's within 1e-4, and the GGUF
    tokenizer comes along."""
    jcfg, jp, _ = tiny()
    path = str(tmp_path / "m.gguf")
    jgguf.write_gguf(path, gguf_metadata(jcfg),
                     named_tensors(jp, jcfg, names))
    data = tloader.load_model_data(path, dtype=torch.float32, device="cpu")
    jdata = jloader.load_model_data(path, dtype=jnp.float32)
    assert data.source_format == "gguf"
    assert isinstance(data.tokenizer, tbpe.SPMTokenizer)
    assert data.tokenizer.tokens == jdata.tokenizer.tokens
    assert_same_params(data.params, jdata.params)
    cfg = data.config.replace(rope_mode=tconfig.RopeMode.HALF)
    np.testing.assert_allclose(port_logits(data.params, cfg),
                               jax_logits(jp, jcfg), atol=LOGIT_ATOL,
                               rtol=1e-4)


@pytest.mark.parametrize("shards", [1, 3])
def test_hf_safetensors_dir_loads_as_jax_loads_it(tmp_path, shards):
    """Single-file and sharded (index.json) HF directories with a
    config.json sidecar, through the index and the directory entry
    points: params bit for bit, config field for field."""
    jcfg, jp, _ = tiny()
    d = str(tmp_path / "ck")
    write_hf_dir(d, named_tensors(jp, jcfg), hf_config(jcfg), shards)
    targets = [d] + ([os.path.join(d, "model.safetensors.index.json")]
                     if shards > 1 else [os.path.join(d,
                                                      "model.safetensors")])
    for target in targets:
        data = tloader.load_model_data(target, dtype=torch.float32,
                                       device="cpu")
        jdata = jloader.load_model_data(target, dtype=jnp.float32)
        assert data.source_format == "safetensors"
        assert_same_params(data.params, jdata.params)
        assert_same_config(data.config, jdata.config)


def test_bf16_safetensors_cast_like_jax(tmp_path):
    """bf16 shards loaded to a bf16 model (no widening on the port's
    side) and to f32: both bit for bit the JAX loader's arrays."""
    jcfg, jp, _ = tiny()
    t = {k: v.astype(ml_dtypes.bfloat16)
         for k, v in named_tensors(jp, jcfg).items()}
    d = str(tmp_path / "bf")
    write_hf_dir(d, t, hf_config(jcfg), shards=2)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        data = tloader.load_model_data(d, dtype=tdt, device="cpu")
        assert data.params["layers"]["wq"].dtype == tdt
        assert_same_params(data.params,
                           jloader.load_model_data(d, dtype=jdt).params)


def test_f16_gguf_casts_like_jax(tmp_path):
    """F16 tensors cast to a bf16 model by way of f32, as JAX does."""
    jcfg, jp, _ = tiny()
    t = {k: v.astype(np.float16) for k, v in
         named_tensors(jp, jcfg, "gguf").items()}
    path = str(tmp_path / "h.gguf")
    jgguf.write_gguf(path, gguf_metadata(jcfg), t)
    assert_same_params(
        tloader.load_gguf(path, device="cpu").params,
        jloader.load_gguf(path).params)


@pytest.mark.parametrize("names", ["hf", "gguf"])
def test_phi3_fused_projections_split_as_jax(tmp_path, names):
    """Phi-3's fused qkv_proj / gate_up_proj (HF) and llama.cpp's
    attn_qkv / double-width ffn_up (GGUF) split into the same slots."""
    jcfg, jp, _ = tiny()
    t = named_tensors(jp, jcfg, names, fused=True)
    if names == "hf":
        d = str(tmp_path / "phi3")
        write_hf_dir(d, t, hf_config(jcfg, "phi3"))
        data = tloader.load_model_data(d, dtype=torch.float32, device="cpu")
        jdata = jloader.load_model_data(d, dtype=jnp.float32)
        assert data.config.architecture == "phi3"
    else:
        path = str(tmp_path / "phi3.gguf")
        jgguf.write_gguf(path, gguf_metadata(jcfg, "phi3"), t)
        data = tloader.load_gguf(path, dtype=torch.float32, device="cpu")
        jdata = jloader.load_gguf(path, dtype=jnp.float32)
    assert_same_params(data.params, jdata.params)
    assert_same_params(data.params["layers"],
                       {k: v for k, v in jp["layers"].items()})


@pytest.mark.parametrize("names", ["hf", "gguf_exps"])
def test_moe_experts_load_as_jax(tmp_path, names):
    """Mixtral-style experts: HF per-expert w1/w3/w2 names and GGUF's
    stacked blk.{i}.ffn_*_exps tensors, to [L, E, in, out] stacks."""
    jcfg, jp, tcfg = tiny("moe")
    L, E = jcfg.num_layers, jcfg.num_experts
    lw = jp["layers"]
    if names == "hf":
        t = {"model.embed_tokens.weight": np.asarray(jp["embed"]),
             "model.norm.weight": np.asarray(jp["final_norm"]),
             "lm_head.weight": np.asarray(jp["lm_head"]).T}
        for i in range(L):
            for s in ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo"):
                a = np.asarray(lw[s][i])
                t[_HF[s].format(i=i)] = np.ascontiguousarray(
                    a if s.endswith("norm") else a.T)
            t[f"model.layers.{i}.block_sparse_moe.gate.weight"] = \
                np.ascontiguousarray(np.asarray(lw["router"][i]).T)
            for e in range(E):
                for s, w in (("we_gate", "w1"), ("we_up", "w3"),
                             ("we_down", "w2")):
                    t[f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}"
                      ".weight"] = np.ascontiguousarray(
                          np.asarray(lw[s][i, e]).T)
        d = str(tmp_path / "mx")
        write_hf_dir(d, t, {**hf_config(jcfg, "mixtral"),
                            "num_local_experts": E,
                            "num_experts_per_tok": 2,
                            "intermediate_size": jcfg.intermediate_size})
        data = tloader.load_model_data(d, dtype=torch.float32, device="cpu")
        jdata = jloader.load_model_data(d, dtype=jnp.float32)
    else:
        t = {"token_embd.weight": np.asarray(jp["embed"]),
             "output_norm.weight": np.asarray(jp["final_norm"]),
             "output.weight": np.asarray(jp["lm_head"]).T}
        for i in range(L):
            for s in ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo"):
                a = np.asarray(lw[s][i])
                t[_GGUF[s].format(i=i)] = np.ascontiguousarray(
                    a if s.endswith("norm") else a.T)
            t[f"blk.{i}.ffn_gate_inp.weight"] = np.ascontiguousarray(
                np.asarray(lw["router"][i]).T)
            for s, k in (("we_gate", "gate"), ("we_up", "up"),
                         ("we_down", "down")):
                t[f"blk.{i}.ffn_{k}_exps.weight"] = np.ascontiguousarray(
                    np.asarray(lw[s][i]).transpose(0, 2, 1))
        md = {**gguf_metadata(jcfg), "llama.expert_count": E,
              "llama.expert_used_count": 2,
              "llama.feed_forward_length": jcfg.intermediate_size}
        path = str(tmp_path / "mx.gguf")
        jgguf.write_gguf(path, md, t)
        data = tloader.load_gguf(path, dtype=torch.float32, device="cpu")
        jdata = jloader.load_gguf(path, dtype=jnp.float32)
        assert data.config.architecture == "mixtral"
    assert_same_params(data.params, jdata.params)
    assert_same_params(data.params["layers"]["we_down"],
                       np.asarray(lw["we_down"]))


def test_gptoss_hf_layout_loads_as_jax(tmp_path):
    """GPT-OSS's HF layout: [E, in, out] expert Parameters with gate/up
    interleaved, biases, sinks, the router: de-interleaved as JAX does."""
    cfg_kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, head_dim=8, intermediate_size=16,
                  num_experts=4, experts_per_token=2, attn_bias=True,
                  architecture="gpt_oss", name="tiny-gptoss")
    jcfg = jconfig.ModelConfig(dtype=jnp.float32, **cfg_kw)
    rng = np.random.default_rng(4)
    H, F, E, QD, KVD = 32, 16, 4, 32, 16
    t = {"model.embed_tokens.weight": rng.normal(size=(64, H)),
         "model.norm.weight": rng.normal(size=(H,)),
         "lm_head.weight": rng.normal(size=(64, H))}
    for i in range(2):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = rng.normal(size=(H,))
        t[f"{p}.post_attention_layernorm.weight"] = rng.normal(size=(H,))
        for nm, o in (("q_proj", QD), ("k_proj", KVD), ("v_proj", KVD)):
            t[f"{p}.self_attn.{nm}.weight"] = rng.normal(size=(o, H))
            t[f"{p}.self_attn.{nm}.bias"] = rng.normal(size=(o,))
        t[f"{p}.self_attn.o_proj.weight"] = rng.normal(size=(H, QD))
        t[f"{p}.self_attn.o_proj.bias"] = rng.normal(size=(H,))
        t[f"{p}.self_attn.sinks"] = rng.normal(size=(4,))
        t[f"{p}.mlp.router.weight"] = rng.normal(size=(E, H))
        t[f"{p}.mlp.router.bias"] = rng.normal(size=(E,))
        t[f"{p}.mlp.experts.gate_up_proj"] = rng.normal(size=(E, H, 2 * F))
        t[f"{p}.mlp.experts.gate_up_proj_bias"] = rng.normal(size=(E, 2 * F))
        t[f"{p}.mlp.experts.down_proj"] = rng.normal(size=(E, F, H))
        t[f"{p}.mlp.experts.down_proj_bias"] = rng.normal(size=(E, H))
    t = {k: v.astype(np.float32) for k, v in t.items()}
    tcfg = tconfig.ModelConfig(dtype=torch.float32, **cfg_kw)
    got = tmapping.assemble_for(tcfg)(t.__getitem__, list(t), tcfg,
                                      device="cpu")
    want = jmapping.assemble_for(jcfg)(t.__getitem__, list(t), jcfg)
    assert_same_params(got, want)


@pytest.mark.parametrize("arch", ["gpt2", "gpt_neox", "falcon", "bloom",
                                  "phi", "deepseek_v2"])
def test_unported_families_refuse_to_assemble(arch):
    with pytest.raises(ModelFormatError, match="ROADMAP item 12"):
        tmapping.assemble_for(tconfig.ModelConfig(architecture=arch))


def test_gemma_gguf_unbakes_norm_offset(tmp_path):
    """llama.cpp's Gemma GGUFs store norm weights with the +1 baked in;
    the loader takes it out (every *norm.weight), as JAX's does."""
    jcfg, jp, _ = tiny()
    t = named_tensors(jp, jcfg, "gguf")
    t = {k: (v + 1.0 if k.endswith("norm.weight") else v)
         for k, v in t.items()}
    path = str(tmp_path / "g.gguf")
    jgguf.write_gguf(path, gguf_metadata(jcfg, "gemma"), t)
    data = tloader.load_gguf(path, dtype=torch.float32, device="cpu")
    assert data.config.norm_offset
    assert_same_params(data.params,
                       jloader.load_gguf(path, dtype=jnp.float32).params)
    np.testing.assert_array_equal(
        data.params["layers"]["attn_norm"].numpy(),
        np.stack([t[f"blk.{i}.attn_norm.weight"] for i in range(2)]) - 1.0)


def test_pytorch_files_load_as_jax(tmp_path):
    """.bin (raw state dict), a {"state_dict": ...} .pt, bf16 tensors,
    and a sharded pytorch_model.bin.index.json directory."""
    jcfg, jp, _ = tiny()
    t = named_tensors(jp, jcfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
    d = tmp_path / "pt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf_config(jcfg)))
    torch.save(sd, str(d / "pytorch_model.bin"))
    torch.save({"state_dict": {k: v.bfloat16() for k, v in sd.items()}},
               str(d / "wrapped.pt"))
    for name in ("pytorch_model.bin", "wrapped.pt"):
        path = str(d / name)
        data = tloader.load_pytorch(path, dtype=torch.float32, device="cpu")
        assert data.source_format == "pytorch"
        assert_same_params(data.params,
                           jloader.load_pytorch(path, dtype=jnp.float32)
                           .params)
    s = tmp_path / "sharded"
    s.mkdir()
    names = sorted(sd)
    weight_map = {}
    for j in range(2):
        fname = f"pytorch_model-0000{j + 1}-of-00002.bin"
        torch.save({k: sd[k] for k in names[j::2]}, str(s / fname))
        weight_map.update({k: fname for k in names[j::2]})
    (s / "pytorch_model.bin.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    (s / "config.json").write_text(json.dumps(hf_config(jcfg)))
    data = tloader.load_model_data(str(s), dtype=torch.float32, device="cpu")
    assert_same_params(data.params, jloader.load_model_data(
        str(s), dtype=jnp.float32).params)


def test_pytorch_corrupt_file_raises(tmp_path):
    path = str(tmp_path / "bad.bin")
    open(path, "wb").write(b"not a checkpoint")
    with pytest.raises(ModelFormatError):
        tloader.load_pytorch(path, device="cpu")


def test_config_inferred_from_shapes_as_jax(tmp_path):
    """No config.json: the config comes from the tensor shapes."""
    jcfg, jp, _ = tiny()
    path = str(tmp_path / "m.safetensors")
    jst.write_safetensors(path, named_tensors(jp, jcfg))
    data = tloader.load_safetensors(path, dtype=torch.float32, device="cpu")
    jdata = jloader.load_safetensors(path, dtype=jnp.float32)
    assert_same_config(data.config, jdata.config)
    assert_same_params(data.params, jdata.params)


def test_formats_and_errors(tmp_path):
    for p, want in (("a.gguf", "gguf"), ("b.safetensors", "safetensors"),
                    ("model.safetensors.index.json", "safetensors"),
                    ("c.tinq", "tinq"), ("d.pt", "pytorch"),
                    ("e.pth", "pytorch"), ("f.bin", "pytorch"),
                    ("g.onnx", "onnx"), ("h.xyz", "unknown")):
        assert tloader.detect_format(p) == want == jloader.detect_format(p)
    onnx = tmp_path / "m.onnx"
    onnx.write_bytes(b"\x00")
    with pytest.raises(ModelFormatError, match="ONNX"):
        tloader.load_model_data(str(onnx), device="cpu")
    with pytest.raises(FileNotFoundError):
        tloader.load_model_data(str(tmp_path / "none.gguf"), device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ModelFormatError, match="no loadable checkpoint"):
        tloader.load_model_data(str(empty), device="cpu")


# -- configs ----------------------------------------------------------------

def assert_same_config(tc, jc):
    """Every field equal; dtype by name."""
    td, jd = tmapping.config_to_dict(tc), jmapping.config_to_dict(jc)
    assert td == jd


_HF_DICTS = {
    "llama3": {"model_type": "llama", "hidden_size": 256,
               "num_attention_heads": 8, "num_key_value_heads": 2,
               "num_hidden_layers": 3, "intermediate_size": 512,
               "rope_theta": 500000.0, "max_position_embeddings": 8192,
               "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192,
                                "rope_type": "llama3"},
               "tie_word_embeddings": True},
    "mistral": {"model_type": "mistral", "sliding_window": 4096},
    "qwen2": {"model_type": "qwen2", "sliding_window": 32768,
              "use_sliding_window": False},
    "gemma2": {"model_type": "gemma2", "head_dim": 128,
               "query_pre_attn_scalar": 144, "sliding_window": 4096,
               "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0},
    "gemma3": {"model_type": "gemma3", "text_config": {
        "hidden_size": 3840, "num_attention_heads": 16, "head_dim": 256,
        "query_pre_attn_scalar": 256, "sliding_window": 1024,
        "rope_local_base_freq": 10000.0,
        "layer_types": ["sliding_attention"] * 5 + ["full_attention"]}},
    "phi3": {"model_type": "phi3", "hidden_size": 3072,
             "intermediate_size": 8192, "num_attention_heads": 32,
             "num_hidden_layers": 32, "vocab_size": 32064,
             "sliding_window": 2047, "max_position_embeddings": 4096},
    "granite": {"model_type": "granite", "embedding_multiplier": 12.0,
                "residual_multiplier": 0.22, "logits_scaling": 8.0,
                "attention_multiplier": 0.0078125},
    "mixtral": {"model_type": "mixtral", "num_local_experts": 8,
                "num_experts_per_tok": 2},
    "qwen2_moe": {"model_type": "qwen2_moe", "num_experts": 60,
                  "moe_intermediate_size": 1408,
                  "shared_expert_intermediate_size": 5632},
    "gpt2": {"model_type": "gpt2", "n_embd": 768, "n_layer": 12,
             "n_head": 12},
    "bloom": {"model_type": "bloom", "n_embed": 1024, "n_head": 16},
    "falcon": {"model_type": "falcon", "multi_query": True},
    "deepseek_v2": {"model_type": "deepseek_v2", "q_lora_rank": 1536,
                    "n_shared_experts": 2,
                    "rope_scaling": {"factor": 40, "type": "yarn"}},
}


@pytest.mark.parametrize("name", sorted(_HF_DICTS))
def test_config_from_hf_dict_as_jax(name):
    hf = _HF_DICTS[name]
    assert_same_config(tmapping.config_from_hf_dict(hf),
                       jmapping.config_from_hf_dict(hf))
    assert_same_config(tmapping.config_from_hf_dict(hf, torch.float32),
                       jmapping.config_from_hf_dict(hf, jnp.float32))


@pytest.mark.parametrize("arch", ["llama", "gemma2", "gemma3", "qwen2moe",
                                  "phi3"])
def test_config_from_gguf_metadata_as_jax(arch):
    md = {"general.architecture": arch, "general.name": f"t-{arch}",
          f"{arch}.embedding_length": 512, f"{arch}.block_count": 46,
          f"{arch}.attention.head_count": 8, f"{arch}.expert_count":
          4 if arch.endswith("moe") else 0,
          f"{arch}.attn_logit_softcapping": 50.0,
          f"{arch}.attention.sliding_window": 1024,
          "tokenizer.ggml.tokens": ["a", "b"], "misc.flag": True}
    assert_same_config(tmapping.config_from_gguf_metadata(md),
                       jmapping.config_from_gguf_metadata(md))


def test_config_dict_round_trips_every_field():
    cfg = tconfig.gemma3_12b_config(
        rope_scaling=(("factor", 8.0), ("rope_type", "linear")),
        extra=(("k", "v"),), embedding_multiplier=2.0, num_experts=4,
        kv_lora_rank=8, dtype=torch.float32)
    d = tmapping.config_to_dict(cfg)
    assert tmapping.config_from_dict(json.loads(json.dumps(d))) == cfg
    jd = jmapping.config_to_dict(jmapping.config_from_dict(d))
    assert jd == d


def test_phi3_mini_config_from_its_hf_dict():
    assert tmapping.config_from_hf_dict(_HF_DICTS["phi3"]).replace(
        name=tconfig.phi3_mini_4k_config().name) == \
        tconfig.phi3_mini_4k_config()


# -- TINQ -------------------------------------------------------------------

def _quantized(qtype, symmetric=True, skip_embeddings=True):
    jcfg, jp, _ = tiny()
    qcfg = jconfig.QuantizationConfig(type=qtype, group_size=32,
                                      symmetric=symmetric,
                                      skip_embeddings=skip_embeddings)
    return jcfg, jquantizer.quantize_params(jp, qcfg), qcfg


_TINQ_CASES = dict(
    argvalues=[(jconfig.QuantType.INT4, True, True),
               (jconfig.QuantType.INT8, True, False),
               (jconfig.QuantType.INT4, False, True)],
    ids=["int4", "int8_qembed", "int4_zero_points"])


@pytest.mark.parametrize("qtype,sym,skip", **_TINQ_CASES)
def test_tinq_both_ways_byte_identical(tmp_path, qtype, sym, skip):
    """A .tinq written by JAX loads in the port into identical QTensors
    (QEmbed included) and configs; the port's writer writes the JAX
    writer's bytes, and JAX loads it back identically."""
    jcfg, jqp, qcfg = _quantized(qtype, sym, skip)
    jpath, tpath = str(tmp_path / "j.tinq"), str(tmp_path / "t.tinq")
    jtinq.save(jpath, jqp, jcfg, qcfg, {"note": "x"})
    params, cfg, tq, meta = ttinq.load(jpath, device="cpu")
    assert_same_params(params, jqp)
    assert_same_config(cfg, jcfg)
    assert meta == {"note": "x"} and tq.type.value == qcfg.type.value
    assert tq.symmetric == sym and tq.skip_embeddings == skip
    ttinq.save(tpath, params, cfg, tq, {"note": "x"})
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    jback = jtinq.load(tpath)[0]
    assert_same_params(params, jback)


def test_tinq_loaded_model_generates_as_jax(tmp_path):
    """The port's load_engine on a JAX-written int4 .tinq: logits within
    1e-4 of JAX's and the greedy trajectory token for token."""
    jcfg, jqp, qcfg = _quantized(jconfig.QuantType.INT4)
    path = str(tmp_path / "m.tinq")
    jtinq.save(path, jqp, jcfg, qcfg)
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1)
    eng = tloader.load_engine(path, tconfig.InferenceConfig(**icfg),
                              device="cpu")
    jeng = jloader.load_engine(path, jconfig.InferenceConfig(**icfg))
    np.testing.assert_allclose(
        port_logits(eng.params, eng.model_config),
        jax_logits(jeng.params, jeng.model_config), atol=LOGIT_ATOL,
        rtol=1e-4)
    prompts = [[1, 5, 9, 33], [7, 2]]
    got = [r.tokens for r in eng.generate_batch(prompts, 10)]
    want = [r.tokens for r in jeng.generate_batch(prompts, 10)]
    assert got == want
    assert isinstance(eng.tokenizer, tbpe.BuiltinTokenizer)


def test_tinq_bad_magic(tmp_path):
    path = str(tmp_path / "bad.tinq")
    open(path, "wb").write(b"NOPE" + b"\x00" * 32)
    with pytest.raises(ModelFormatError, match="magic"):
        ttinq.load(path, device="cpu")


def test_quantize_model_file_as_jax(tmp_path):
    """load -> quantize -> TINQ from an HF directory: the port's file is
    the JAX package's, byte for byte."""
    jcfg, jp, _ = tiny()
    d = str(tmp_path / "hf")
    write_hf_dir(d, named_tensors(jp, jcfg), hf_config(jcfg))
    jq = jconfig.QuantizationConfig(type=jconfig.QuantType.INT4,
                                    group_size=32)
    tq = tconfig.QuantizationConfig(type=tconfig.QuantType.INT4,
                                    group_size=32)
    jquantizer.quantize_model_file(d, str(tmp_path / "j.tinq"), jq)
    tquantizer.quantize_model_file(d, str(tmp_path / "t.tinq"), tq,
                                   device="cpu")
    assert (tmp_path / "t.tinq").read_bytes() == \
        (tmp_path / "j.tinq").read_bytes()


# -- engine, tokenizer ------------------------------------------------------

def test_load_engine_gguf_tokenizer_and_eos(tmp_path):
    """load_engine of a GGUF attaches its tokenizer and takes eos from
    it; greedy tokens equal JAX load_engine's."""
    jcfg, jp, _ = tiny()
    path = str(tmp_path / "m.gguf")
    md = gguf_metadata(jcfg)
    md["tokenizer.ggml.eos_token_id"] = 7
    jgguf.write_gguf(path, md, named_tensors(jp, jcfg, "gguf"))
    eng = tloader.load_engine(path, device="cpu")
    jeng = jloader.load_engine(path)
    assert isinstance(eng.tokenizer, tbpe.SPMTokenizer)
    assert eng.config.eos_token_id == 7 == jeng.config.eos_token_id
    assert eng.config.max_seq_len == jcfg.max_seq_len
    got = eng.generate_batch([[1, 4, 8]], 6, temperature=0.0)[0].tokens
    want = jeng.generate_batch([[1, 4, 8]], 6, temperature=0.0)[0].tokens
    assert got == want


def _spm_vocab():
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    toks += ["▁", "▁h", "▁he", "ll", "llo", "▁hello", "▁w", "or", "ld",
             "▁world", "é"]
    scores = [0.0] * len(toks)
    for i, t in enumerate(toks[259:]):
        scores[259 + i] = -float(len(toks) - i) + len(t)
    return toks, scores


@pytest.mark.parametrize("use_native", [True, False])
def test_spm_tokenizer_as_jax(monkeypatch, use_native):
    toks, scores = _spm_vocab()
    if not use_native:
        monkeypatch.setattr(tbpe.SPMTokenizer, "_native_encoder",
                            lambda self: None)
    t = tbpe.SPMTokenizer(toks, scores)
    j = jbpe.SPMTokenizer(toks, scores)
    for text in ("hello world", " hello  world!", "héllo\nworld", ""):
        ids = t.encode(text, add_bos=True)
        assert ids == j.encode(text, add_bos=True)
        assert t.decode(ids) == j.decode(ids)


def test_bpe_and_builtin_tokenizers_as_jax():
    md = {"tokenizer.ggml.model": "gpt2",
          "tokenizer.ggml.tokens": ["h", "e", "l", "o", "Ġ", "w", "he",
                                    "ll", "hell", "hello", "Ġw"],
          "tokenizer.ggml.merges": ["h e", "l l", "he ll", "hell o",
                                    "Ġ w"]}
    t, j = tbpe.from_gguf_metadata(md), jbpe.from_gguf_metadata(md)
    assert isinstance(t, tbpe.BPETokenizer)
    assert t.encode("hello wo") == j.encode("hello wo")
    assert t.decode(t.encode("hello")) == j.decode(j.encode("hello"))
    bt, bj = tbpe.BuiltinTokenizer(400), jbpe.BuiltinTokenizer(400)
    assert bt.encode("The water, 7 ü") == bj.encode("The water, 7 ü")
    assert bt.decode(bt.encode("good day")) == "good day"
    assert tbpe.from_gguf_metadata({}) is None
    msgs = [{"role": "user", "content": "hi"}]
    assert bt.apply_chat_template(msgs) == bj.apply_chat_template(msgs)
    assert bt.apply_chat_template(msgs, tokenize=True) == \
        bj.apply_chat_template(msgs, tokenize=True)


# -- checkpoints ------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint / load_checkpoint: int4 QTensors with zero points,
    a QEmbed and fp leaves come back bit for bit, with the config and the
    user metadata; the manifest keeps the JAX package's fields."""
    jcfg, jqp, _ = _quantized(jconfig.QuantType.INT4, symmetric=False,
                              skip_embeddings=False)
    params = bridge.params_from_numpy(jax_to_numpy(jqp), device="cpu")
    cfg = tmapping.config_from_dict(jmapping.config_to_dict(jcfg))
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, params, cfg, metadata={"step": 3})
    got, cfg2, md = tckpt.load_checkpoint(d, device="cpu")
    assert_same_params(got, jqp)
    assert cfg2 == cfg and md == {"step": 3}
    man = json.load(open(os.path.join(d, "turboinfer_manifest.json")))
    assert set(man) == {"format", "version", "config", "qtensors",
                        "metadata"}
    assert man["qtensors"]["layers/wq"] == {"kind": "qtensor", "bits": 4,
                                            "group_size": 32,
                                            "shape": [128, 128]}
    np.testing.assert_allclose(port_logits(got, cfg2),
                               jax_logits(jqp, jcfg), atol=LOGIT_ATOL,
                               rtol=1e-4)


def test_checkpoint_refuses_orbax_and_mesh(tmp_path):
    jcfg, jp, _ = tiny()
    d = str(tmp_path / "orbax")
    jckpt.save_checkpoint(d, jp, jcfg)
    with pytest.raises(ModelFormatError, match="Orbax"):
        tckpt.load_checkpoint(d, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        tckpt.load_checkpoint(d, mesh=object(), device="cpu")


# -- the qtensor and quantizer remainders -----------------------------------

def test_qtensor_blobs_error_and_ratio_as_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(128, 96)).astype(np.float32)
    for sym in (True, False):
        jq = jqt.quantize(jnp.asarray(w), jconfig.QuantType.INT4,
                          group_size=32, symmetric=sym)
        tq = tqt.quantize(torch.from_numpy(w), tconfig.QuantType.INT4,
                          group_size=32, symmetric=sym)
        jb, tb = jqt.to_numpy_blobs(jq), tqt.to_numpy_blobs(tq)
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k].tobytes() == np.asarray(jb[k]).tobytes()
        back = tqt.from_numpy_blobs(tb, 4, 32, (128, 96))
        assert_same_params({"w": back}, {"w": jq})
        assert tqt.quantization_error(torch.from_numpy(w), tq) == \
            pytest.approx(jqt.quantization_error(jnp.asarray(w), jq),
                          rel=1e-6)
    for qtype in ("int8", "int4", "float16", "none"):
        assert tqt.estimate_compression_ratio(
            (4096, 11008), tconfig.QuantType(qtype), 64, False) == \
            jqt.estimate_compression_ratio(
                (4096, 11008), jconfig.QuantType(qtype), 64, False)


def test_float16_and_dequantize_params_as_jax():
    jcfg, jp, _ = tiny()
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    f16 = jconfig.QuantizationConfig(type=jconfig.QuantType.FLOAT16)
    assert_same_params(
        tquantizer.quantize_params(tp, tconfig.QuantizationConfig(
            type=tconfig.QuantType.FLOAT16)),
        jquantizer.quantize_params(jp, f16))
    _, jqp, _ = _quantized(jconfig.QuantType.INT4, symmetric=False,
                           skip_embeddings=False)
    tqp = bridge.params_from_numpy(jax_to_numpy(jqp), device="cpu")
    assert_same_params(tquantizer.dequantize_params(tqp),
                       jquantizer.dequantize_params(jqp))


def test_validate_quantization_accuracy_as_jax():
    jcfg, jp, tcfg = tiny()
    _, jqp, _ = _quantized(jconfig.QuantType.INT4)
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    tqp = bridge.params_from_numpy(jax_to_numpy(jqp), device="cpu")
    got = tquantizer.validate_quantization_accuracy(tp, tqp, tcfg)
    want = jquantizer.validate_quantization_accuracy(jp, jqp, jcfg)
    for f in ("mean_abs_logprob_delta", "max_abs_logprob_delta",
              "perplexity_fp", "perplexity_quant"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=1e-3, abs=1e-5), f
    assert got.perplexity_ratio == pytest.approx(want.perplexity_ratio,
                                                 rel=1e-3)
