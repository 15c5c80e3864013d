"""The port's text modules (tokenizer/hf.py, chat.py, stream.py) against
the JAX package's and against `tokenizers` / `transformers` as golden.

Tokenizers of three flavours (byte-level BPE, Metaspace BPE with
byte_fallback, Unigram) are trained here with the local `tokenizers`
and saved as tokenizer.json; the port, the JAX package and `tokenizers`
must give identical ids on the same texts, hypothesis strings included.
Chat templates render identically to the JAX package's and to
transformers'. The Phi-3-style files that chip_smoke.py writes for the
card read identically in all three. Nothing is fetched.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tokenizers import Tokenizer as HFRef
from tokenizers import decoders, models, normalizers, pre_tokenizers, trainers

import chip_smoke
from turboinfer_tpu.tokenizer import bpe as jbpe
from turboinfer_tpu.tokenizer import chat as jchat
from turboinfer_tpu.tokenizer import hf as jhf
from turboinfer_tpu.tokenizer import stream as jstream
from turboinfer_tpu_torch.tokenizer import bpe as tbpe
from turboinfer_tpu_torch.tokenizer import chat as tchat
from turboinfer_tpu_torch.tokenizer import hf as thf
from turboinfer_tpu_torch.tokenizer import stream as tstream

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent

CORPUS = [
    "Hello, world!", "the quick brown fox jumps over the lazy dog",
    "  leading and   internal   spaces  ", "numbers 12345 and mixed a1b2c3",
    "punct!?.,;:'\"()[]{}", "tab\tand\nnewline", "unicode: héllo wörld ñ",
    "emoji 🎉 and CJK 你好世界", "code: def f(x): return x**2  # comment",
    "don't can't won't it's", "", "a", " ", "camelCaseAndPascalCase",
    "<|im_start|>user\nhi<|im_end|>", "plain <|im_start|> then more"]
TRAIN = [
    "hello world the quick brown fox jumps over the lazy dog",
    "numbers 123 456 789 and words mixed together",
    "don't stop believing, hold on to that feeling",
    "def function(argument): return argument + 1",
    "punctuation, is! important? yes; it: is.",
    "the the the a a a an an of of to to in in"] * 4


def _byte_level():
    ref = HFRef(models.BPE())
    ref.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    ref.decoder = decoders.ByteLevel()
    ref.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    ref.add_special_tokens(["<|im_start|>", "<|im_end|>"])
    return ref


def _metaspace():
    ref = HFRef(models.BPE(unk_token="<unk>", byte_fallback=True,
                           fuse_unk=True))
    ref.normalizer = normalizers.Sequence([
        normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    ref.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(),
        decoders.Strip(" ", 1, 0)])
    ref.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=700, special_tokens=["<unk>", "<s>", "</s>"]
        + [f"<0x{b:02X}>" for b in range(256)]))
    ref.add_special_tokens(["<|im_start|>", "<|im_end|>"])
    return ref


def _unigram():
    ref = HFRef(models.Unigram())
    ref.pre_tokenizer = pre_tokenizers.Metaspace()
    ref.decoder = decoders.Metaspace()
    ref.train_from_iterator(TRAIN, trainers.UnigramTrainer(
        vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"],
        unk_token="<unk>"))
    return ref


FLAVOURS = {"byte_level": _byte_level, "metaspace": _metaspace,
            "unigram": _unigram}
_DIRS = {}


def flavour(name, tmp_path_factory):
    """(tokenizers ref, port tokenizer, JAX tokenizer) of a flavour,
    read from the same tokenizer.json + tokenizer_config.json."""
    return flavour_dir(name, tmp_path_factory)[:3]


def flavour_dir(name, tmp_path_factory):
    """flavour()'s three tokenizers and the directory of their files."""
    if name not in _DIRS:
        d = tmp_path_factory.mktemp(name)
        ref = FLAVOURS[name]()
        ref.save(str(d / "tokenizer.json"))
        with open(d / "tokenizer_config.json", "w") as f:
            json.dump({"bos_token": "<s>", "eos_token": "</s>"}, f)
        _DIRS[name] = (ref, thf.from_hf_dir(str(d)), jhf.from_hf_dir(str(d)),
                       d)
    return _DIRS[name]


@pytest.mark.parametrize("name", list(FLAVOURS))
def test_flavours_encode_as_jax_and_tokenizers(name, tmp_path_factory):
    ref, ours, theirs = flavour(name, tmp_path_factory)
    assert ours.kind == theirs.kind and ours.tokens == theirs.tokens
    assert (ours.bos_id, ours.eos_id, ours.vocab_size) == (
        theirs.bos_id, theirs.eos_id, theirs.vocab_size)
    for text in CORPUS:
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        if name != "unigram" or "<|im" not in text:
            assert ids == ref.encode(text, add_special_tokens=False).ids
        assert ours.decode(ids) == theirs.decode(ids)
        assert ours.encode(text, add_bos=True) == theirs.encode(text,
                                                               add_bos=True)


@pytest.mark.parametrize("name", list(FLAVOURS))
@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=40))
def test_flavours_on_hypothesis_strings(name, tmp_path_factory, text):
    ref, ours, theirs = flavour(name, tmp_path_factory)
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert ids == ref.encode(text, add_special_tokens=False).ids
    assert ours.decode(ids) == theirs.decode(ids)


@pytest.mark.parametrize("name", list(FLAVOURS))
def test_incremental_decoder_as_jax(name, tmp_path_factory):
    """Streamed deltas equal the JAX decoder's, token for token, and
    concatenate to decode() of the whole output (split UTF-8 included)."""
    _, ours, theirs = flavour(name, tmp_path_factory)
    for text in CORPUS[1:10]:
        ids = ours.encode(text)
        a, b = tstream.IncrementalDecoder(ours), jstream.IncrementalDecoder(
            theirs)
        deltas = [a.push(t) for t in ids]
        assert deltas == [b.push(t) for t in ids]
        assert a.flush() == b.flush()
        assert "".join(deltas) == ours.decode(ids)


def test_incremental_decoder_without_table():
    """A tokenizer with no .tokens table re-decodes (withholding a
    trailing U+FFFD), as JAX's does."""
    class Toy:
        def decode(self, ids):
            return bytes(ids).decode("utf-8", errors="replace")
    a, b = tstream.IncrementalDecoder(Toy()), jstream.IncrementalDecoder(
        Toy())
    seq = list("héllo".encode())
    assert [a.push(t) for t in seq] == [b.push(t) for t in seq]
    assert tstream.IncrementalDecoder(None).push(5) == ""


MESSAGES = [{"role": "system", "content": "You are terse."},
            {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"},
            {"role": "user", "content": "what's 2+2?"}]
ZEPHYR_TPL = (
    "{% for message in messages %}\n"
    "{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n"
    "{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n"
    "{% endif %}\n"
    "{% endfor %}")
MISTRAL_TPL = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}"
    "{{ message['content'] + eos_token}}"
    "{% endif %}{% endfor %}")
TEMPLATES = {"zephyr": ZEPHYR_TPL, "mistral": MISTRAL_TPL,
             "chatml": tchat.DEFAULT_TEMPLATE,
             "phi3": chip_smoke.PHI3_CHAT_TEMPLATE}


def _transformers_render(tpl, messages, add_generation_prompt):
    from transformers import PreTrainedTokenizerFast
    tok = PreTrainedTokenizerFast(
        tokenizer_object=HFRef(models.BPE(vocab={"a": 0}, merges=[])),
        bos_token="<s>", eos_token="</s>")
    tok.chat_template = tpl
    return tok.apply_chat_template(messages, tokenize=False,
                                   add_generation_prompt=add_generation_prompt)


@pytest.mark.parametrize("name", list(TEMPLATES))
@pytest.mark.parametrize("agp", [True, False])
def test_templates_render_as_jax_and_transformers(name, agp):
    tpl = TEMPLATES[name]
    msgs = MESSAGES[1:] if name == "mistral" else MESSAGES
    ours = tchat.ChatTemplate(tpl, bos_token="<s>", eos_token="</s>")
    theirs = jchat.ChatTemplate(tpl, bos_token="<s>", eos_token="</s>")
    out = ours.render(msgs, add_generation_prompt=agp)
    assert out == theirs.render(msgs, add_generation_prompt=agp)
    assert out == _transformers_render(tpl, msgs, agp)


def test_template_helpers_and_config_forms():
    tpl = ("{% if messages[0]['role'] != 'user' %}"
           "{{ raise_exception('first must be user') }}{% endif %}"
           "{{ messages | tojson }}")
    for mod in (tchat, jchat):
        t = mod.ChatTemplate(tpl)
        assert t.render([{"role": "user", "content": "é"}]) == \
            '[{"role": "user", "content": "é"}]'
        with pytest.raises(ValueError, match="first must be user"):
            t.render([{"role": "system", "content": "x"}])
    for tc in ({"chat_template": "A{{ bos_token }}", "bos_token": "<s>"},
               {"chat_template": [{"name": "tool_use", "template": "T"},
                                  {"name": "default", "template": "D"}]},
               {"chat_template": "{{ bos_token }}",
                "bos_token": {"content": "<bos>", "special": True}},
               {}, None):
        a, b = tchat.from_tokenizer_config(tc), jchat.from_tokenizer_config(tc)
        assert (a.source, a.is_default, a.bos_token, a.eos_token) == (
            b.source, b.is_default, b.bos_token, b.eos_token)
        assert a.render(MESSAGES) == b.render(MESSAGES)


def test_gguf_template_attaches_as_jax():
    md = {"tokenizer.ggml.model": "llama",
          "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "▁hi", "▁there"],
          "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0, -2.0],
          "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
          "tokenizer.chat_template": MISTRAL_TPL}
    ours, theirs = tbpe.from_gguf_metadata(md), jbpe.from_gguf_metadata(md)
    assert ours.chat_template is not None and not ours.chat_template.is_default
    msgs = MESSAGES[1:2]
    assert ours.apply_chat_template(msgs) == theirs.apply_chat_template(msgs)
    assert ours.apply_chat_template(msgs, tokenize=True) == \
        theirs.apply_chat_template(msgs, tokenize=True)
    del md["tokenizer.chat_template"]
    assert tbpe.from_gguf_metadata(md).chat_template is None


def test_apply_chat_template_keeps_one_bos(tmp_path_factory):
    """tokenize=True adds the BOS once: not again when the template
    already renders it."""
    _, ours, theirs = flavour("metaspace", tmp_path_factory)
    msgs = MESSAGES[1:2]
    ids = ours.apply_chat_template(msgs, tokenize=True)
    assert ids == theirs.apply_chat_template(msgs, tokenize=True)
    assert ids[0] == ours.bos_id
    baked = tchat.ChatTemplate("{{ bos_token }}{{ messages[0]['content'] }}",
                               bos_token="<s>")
    ours.chat_template = baked
    ids = ours.apply_chat_template(msgs, tokenize=True)
    assert ids[0] == ours.bos_id and ids[1] != ours.bos_id
    ours.chat_template = None


@pytest.fixture(scope="module")
def phi3_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("phi3_tok")
    chip_smoke.write_phi3_tokenizer(str(d))
    return d


@pytest.fixture(scope="module")
def phi3_tokenizers(phi3_dir):
    """(tokenizers ref, port tokenizer) of chip_smoke's Phi-3 files."""
    return (HFRef.from_file(str(phi3_dir / "tokenizer.json")),
            thf.from_hf_dir(str(phi3_dir)))


def test_phi3_files_read_alike_everywhere(phi3_dir):
    """chip_smoke.py's Phi-3-style tokenizer files: 32000 pieces, the
    added tokens at Phi-3's ids, the chat template; ids identical in
    the port, the JAX package and `tokenizers`, round trips exact."""
    ref = HFRef.from_file(str(phi3_dir / "tokenizer.json"))
    ours, theirs = thf.from_hf_dir(str(phi3_dir)), jhf.from_hf_dir(
        str(phi3_dir))
    assert isinstance(ours, thf.HFTokenizer)
    assert ours.vocab_size == theirs.vocab_size == 32011
    assert ref.get_vocab_size() == 32011
    assert (ours.bos_id, ours.eos_id) == (1, 32000)
    assert ours.added["<|user|>"] == 32010 and ours.added["<|end|>"] == 32007
    assert ours.byte_fallback and ours.fuse_unk
    assert not ours.chat_template.is_default
    msgs = MESSAGES
    text = ours.apply_chat_template(msgs)
    assert text == theirs.apply_chat_template(msgs)
    assert text == _transformers_render(chip_smoke.PHI3_CHAT_TEMPLATE, msgs,
                                        True)
    assert text.endswith("<|end|>\n<|assistant|>\n")
    for t in (chip_smoke.PHI3_ROUND_TRIP, chip_smoke.PHI3_FIXED_TEXT, text,
              "a  b\n\tc", "<|user|>\nGrüße<|end|>\n"):
        ids = ours.encode(t)
        assert ids == theirs.encode(t)
        assert ids == ref.encode(t, add_special_tokens=False).ids
    ids = ours.encode(chip_smoke.PHI3_ROUND_TRIP)
    assert ours.decode(ids) == chip_smoke.PHI3_ROUND_TRIP
    assert any(ours.tokens[i].startswith("<0x") for i in ids)
    assert ours.apply_chat_template(msgs, tokenize=True) == \
        theirs.apply_chat_template(msgs, tokenize=True)


@settings(max_examples=40, deadline=None)
@given(text=st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                    max_size=30))
def test_phi3_files_on_hypothesis_strings(phi3_tokenizers, text):
    ref, ours = phi3_tokenizers
    assert ours.encode(text) == ref.encode(text, add_special_tokens=False).ids


def test_loader_attaches_the_sidecar(tmp_path, phi3_dir):
    """load_model_data of an HF directory attaches its tokenizer.json
    (with tokenizer_config.json's template), as the JAX loader does; a
    corrupt sidecar is logged and skipped."""
    from turboinfer_tpu.loader import loader as jloader
    from turboinfer_tpu_torch.config import phi3_mini_4k_config
    from turboinfer_tpu_torch.loader import loader as tloader
    from turboinfer_tpu_torch.models import llama
    cfg = phi3_mini_4k_config(vocab_size=64, hidden_size=64, num_layers=1,
                              num_heads=2, num_kv_heads=2,
                              intermediate_size=64, max_seq_len=32,
                              dtype=torch.float32)
    d = tmp_path / "hf"
    d.mkdir()
    config_json = dict(chip_smoke.PHI3_MINI_4K_CONFIG_JSON, vocab_size=64,
                       hidden_size=64, num_hidden_layers=1,
                       num_attention_heads=2, num_key_value_heads=2,
                       intermediate_size=64, max_position_embeddings=32,
                       original_max_position_embeddings=32,
                       torch_dtype="float32")
    chip_smoke.write_hf_checkpoint(
        str(d), chip_smoke.phi3_hf_tensors(llama.init_params(cfg, seed=0,
                                                             device="cpu"),
                                           cfg), config_json)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (d / name).write_bytes((phi3_dir / name).read_bytes())
    data = tloader.load_model_data(str(d), device="cpu")
    jdata = jloader.load_model_data(str(d))
    assert isinstance(data.tokenizer, thf.HFTokenizer)
    assert data.tokenizer.chat_template.source == chip_smoke.PHI3_CHAT_TEMPLATE
    assert data.tokenizer.encode(chip_smoke.PHI3_ROUND_TRIP) == \
        jdata.tokenizer.encode(chip_smoke.PHI3_ROUND_TRIP)
    eng = tloader.load_engine(str(d), device="cpu")
    assert eng.tokenizer is not None and eng.tokenizer.eos_id == 32000
    (d / "tokenizer.json").write_text("{not json")
    assert tloader.load_model_data(str(d), device="cpu").tokenizer is None


_HIDE_REGEX = """
import sys
sys.modules["regex"] = None
from turboinfer_tpu_torch.tokenizer import hf
tok = hf.from_hf_dir(sys.argv[1])
print(tok.encode("Grüße, world!"))
try:
    hf.from_hf_dir(sys.argv[2])
except ImportError as e:
    print("ImportError", "regex" in str(e))
"""


def test_hf_imports_and_reads_metaspace_without_regex(tmp_path_factory):
    """The card machine has no `regex`: hf.py imports without it, a
    Metaspace tokenizer works, a ByteLevel one raises ImportError naming
    regex."""
    ms_dir = flavour_dir("metaspace", tmp_path_factory)[3]
    bl_dir = flavour_dir("byte_level", tmp_path_factory)[3]
    r = subprocess.run([sys.executable, "-c", _HIDE_REGEX, str(ms_dir),
                        str(bl_dir)], capture_output=True, text=True,
                       cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    want = flavour("metaspace", tmp_path_factory)[1].encode("Grüße, world!")
    assert lines == [str(want), "ImportError True"]
