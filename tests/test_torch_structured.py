"""The port's structured/ (json_fsm, regex_nfa, schema_fsm, filter)
against the JAX package's: the same byte strings accepted and rejected,
the same grammar states, and TokenMaskCache masks and bias rows equal
array for array for the same tokenizer and states; JsonTokenFilter picks
the same tokens.
"""

import json
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from turboinfer_tpu.structured import filter as jfilter
from turboinfer_tpu.structured import json_fsm as jjson
from turboinfer_tpu.structured import regex_nfa as jregex
from turboinfer_tpu.structured import schema_fsm as jschema
from turboinfer_tpu.tokenizer.bpe import BuiltinTokenizer as JBuiltin
from turboinfer_tpu_torch.structured import filter as tfilter
from turboinfer_tpu_torch.structured import json_fsm as tjson
from turboinfer_tpu_torch.structured import regex_nfa as tregex
from turboinfer_tpu_torch.structured import schema_fsm as tschema
from turboinfer_tpu_torch.tokenizer.bpe import BuiltinTokenizer

torch.set_num_threads(2)

# the cases of tests/test_structured.py
VALID = ['{}', '{"a": 1}', '{"a": -0.5e+10, "b": [1, 2, 3]}',
         '{"nested": {"deep": [{"x": null}, true, false]}}',
         '{ "ws" :\n[ 1 ,\t2 ] }', '{"esc": "a\\"b\\\\c\\n\\u00e9"}',
         '{"unicode": "héllo 🎉"}', '{"empty_arr": [], "empty_obj": {}}']
INVALID = ['', '[1, 2]', '"str"', '{"a": 1,}', '{"a" 1}', "{'a': 1}",
           '{"a": 01}', '{"a": 1} extra', '{"a": .5}', '{"a": tru}',
           '{"a": "unterminated}', '{"a": 1']
SCHEMAS = {
    "mixed": {"type": "object",
              "properties": {
                  "name": {"type": "string", "maxLength": 12},
                  "age": {"type": "integer"},
                  "mood": {"type": "string", "enum": ["happy", "sad"]},
                  "tags": {"type": "array",
                           "items": {"type": "string", "maxLength": 6},
                           "minItems": 1, "maxItems": 3},
                  "meta": {"type": "object",
                           "properties": {"ok": {"type": "boolean"}},
                           "required": ["ok"]}},
              "required": ["name", "age", "mood", "tags", "meta"]},
    "bounded": {"type": "object",
                "properties": {"name": {"type": "string", "maxLength": 12},
                               "age": {"type": "integer", "minimum": 0,
                                       "maximum": 150},
                               "tag": {"type": "string",
                                       "enum": ["alpha", "beta", "gamma"]}},
                "required": ["name", "age", "tag"]},
    "optional_anyof": {"type": "object",
                       "properties": {
                           "a": {"type": "integer",
                                 "exclusiveMinimum": -5, "maximum": 40},
                           "b": {"anyOf": [{"type": "string"},
                                           {"type": "null"},
                                           {"type": "number"}]},
                           "c": {"type": "boolean"}},
                       "required": ["a"]},
    "pattern": {"type": "object",
                "properties": {"id": {"type": "string",
                                      "pattern": "^[a-z]{3}-[0-9]{2}$"},
                               "note": {"type": "string",
                                        "pattern": "\\d+x?",
                                        "minLength": 2}},
                "required": ["id", "note"]},
    "number": {"type": "integer", "minimum": -30, "maximum": 1000},
}


@pytest.mark.parametrize("text", VALID + INVALID)
@pytest.mark.parametrize("require_object", [True, False])
def test_json_fsm_cases_as_jax(text, require_object):
    a = tjson.advance_bytes(tjson.initial(require_object), text.encode())
    b = jjson.advance_bytes(jjson.initial(require_object), text.encode())
    assert a == b
    assert (a is not None and tjson.done(a)) == (
        b is not None and jjson.done(b))
    if text in VALID:
        assert tjson.done(a)


@settings(max_examples=300, deadline=None)
@given(data=st.binary(max_size=24) | st.text(
    alphabet='{}[]:,"\\ 0123456789.-+eEtrufalsn\n', max_size=24).map(
        str.encode))
def test_json_fsm_bytes_as_jax(data):
    """Every prefix reaches the same state (or the same rejection)."""
    for req in (True, False):
        a, b = tjson.initial(req), jjson.initial(req)
        for i in range(len(data)):
            a, b = tjson.advance(a, data[i]), jjson.advance(b, data[i])
            assert a == b
            if a is None:
                break
        if a is not None:
            assert tjson.done(a) == jjson.done(b)
            assert tjson.number_can_end(a) == jjson.number_can_end(b)


PATTERNS = ["^[a-z]{3}-[0-9]{2}$", "\\d+x?", "(ab|cd)*e", "^a.c$",
            "[^0-9]{2,4}", "\\w\\s\\W", "^(?:x|yz){1,3}$", "colou?r",
            "a{0}b", "^$"]


@pytest.mark.parametrize("pattern", PATTERNS)
@settings(max_examples=25, deadline=None)
@given(text=st.text(alphabet="abcdexyz-0123456789 r_.!", max_size=12))
def test_regex_nfa_as_jax(pattern, text):
    a, b = tregex.RegexNFA(pattern), jregex.RegexNFA(pattern)
    na, nb = a.start_set, b.start_set
    assert na == nb
    for ch in text.encode():
        na, nb = a.step(na, ch), b.step(nb, ch)
        assert na == nb
        if na is None:                      # no node survives the byte
            break
        assert a.feasible(na, 40) == b.feasible(nb, 40)
    else:
        assert a.accepting(na) == b.accepting(nb)
    assert a.dist_to_accept == b.dist_to_accept


@pytest.mark.parametrize("bad", ["(ab", "a{3,1}", "[z-a]", "a**"])
def test_regex_nfa_refusals_as_jax(bad):
    errors = []
    for mod in (tregex, jregex):
        try:
            mod.RegexNFA(bad)
            errors.append(None)
        except mod.PatternError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


def _walk_states(fsm, rng, max_bytes=300):
    """One random walk over a schema FSM's legal printable bytes: the
    byte string and the states along it."""
    stt, out, states = fsm.initial(), bytearray(), []
    for _ in range(max_bytes):
        states.append(stt)
        if fsm.done(stt):
            break
        legal = [b for b in range(0x20, 0x7F)
                 if fsm.advance(stt, b) is not None]
        if not legal or (fsm.may_finish(stt) and rng.random() < 0.3):
            break
        b = rng.choice(legal)
        stt = fsm.advance(stt, b)
        out.append(b)
    return bytes(out), states


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_schema_fsm_walks_as_jax(name):
    """Random walks over the port's schema FSM: the JAX FSM reaches the
    same state after every byte, agrees on done/may_finish/mask_key, and
    rejects the same next bytes; finished documents parse."""
    a, b = tschema.SchemaFSM(SCHEMAS[name]), jschema.SchemaFSM(SCHEMAS[name])
    rng = random.Random(7)
    for _ in range(12):
        data, _ = _walk_states(a, rng)
        sa, sb = a.initial(), b.initial()
        for ch in data:
            for probe in (ch, 0x22, 0x7D, 0x31, 0x2C):
                assert (a.advance(sa, probe) is None) == (
                    b.advance(sb, probe) is None)
            sa, sb = a.advance(sa, ch), b.advance(sb, ch)
            assert sa == sb
            assert (a.done(sa), a.may_finish(sa), a.mask_key(sa)) == (
                b.done(sb), b.may_finish(sb), b.mask_key(sb))
        if a.done(sa) or a.may_finish(sa):
            json.loads(data.decode())


@pytest.mark.parametrize("bad", [{"$ref": "#/x"}, {"type": ["string",
                                                           "null"]},
                                 {"type": "array"}, {"enum": [1, 12]}])
def test_schema_refusals_as_jax(bad):
    with pytest.raises(tschema.SchemaError) as ours:
        tschema.SchemaFSM(bad)
    with pytest.raises(jschema.SchemaError) as theirs:
        jschema.SchemaFSM(bad)
    assert str(ours.value) == str(theirs.value)


def _json_piece_tok(mod_tokens):
    """A tokenizer-shaped vocab of multi-byte JSON pieces (multi-pop
    tokens included), as tests/test_structured.py builds it."""
    from types import SimpleNamespace
    pieces = ["<pad>", "{", "}", "[", "]", ",", ":", '"', " ", "a", "b",
              "x", "1", "2", "0", "-", ".", "e", "true", "false", "null",
              '{"', '": ', '"}', '":', ', "', "}}", "]}", '},{"', '}},[',
              '"a"', '[{'] + mod_tokens
    return SimpleNamespace(tokens=pieces, special_ids=(0,), added={},
                           byte_level=False)


def _toks(kind):
    if kind == "builtin":
        return BuiltinTokenizer(vocab_size=1000), JBuiltin(vocab_size=1000)
    return _json_piece_tok([]), _json_piece_tok([])


@pytest.mark.parametrize("kind", ["builtin", "pieces"])
@pytest.mark.parametrize("grammar", ["json_object", "json", "bounded",
                                     "mixed", "number"])
def test_mask_cache_as_jax(kind, grammar):
    """mask() and bias_row() of every state along greedy-random walks
    equal JAX's arrays; advance() agrees token for token."""
    tt, jt = _toks(kind)
    assert tfilter.token_bytes_table(tt) == jfilter.token_bytes_table(jt)
    fsm_t = fsm_j = None
    if grammar in SCHEMAS:
        fsm_t = tschema.SchemaFSM(SCHEMAS[grammar])
        fsm_j = jschema.SchemaFSM(SCHEMAS[grammar])
    req = grammar != "json"
    a = tfilter.TokenMaskCache(tt, require_object=req, fsm=fsm_t)
    b = jfilter.TokenMaskCache(jt, require_object=req, fsm=fsm_j)
    eos = 2 if kind == "builtin" else 0
    rng = np.random.default_rng(3)
    for _ in range(3):
        sa, sb = a.initial(), b.initial()
        for _ in range(40):
            ma, mb = a.mask(sa), b.mask(sb)
            assert np.array_equal(ma, mb)
            ra, rb = a.bias_row(sa, eos), b.bias_row(sb, eos)
            assert ra.dtype == rb.dtype and np.array_equal(ra, rb)
            if a.done(sa) or not ma.any():
                break
            tid = int(rng.choice(np.nonzero(ma)[0]))
            sa, sb = a.advance(sa, tid), b.advance(sb, tid)
            assert sa == sb and sa is not None


@pytest.mark.parametrize("grammar", ["json_object", "bounded"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_token_filter_picks_as_jax(grammar, temperature):
    """JsonTokenFilter.pick on the same logits (and the same numpy
    generator when sampling) picks the same tokens to the end."""
    tt, jt = _toks("builtin")
    fsm = (lambda m: m.SchemaFSM(SCHEMAS["bounded"])) \
        if grammar == "bounded" else (lambda m: None)
    a = tfilter.JsonTokenFilter(tt, fsm=fsm(tschema), eos_id=2)
    b = jfilter.JsonTokenFilter(jt, fsm=fsm(jschema), eos_id=2)
    logits_rng = np.random.default_rng(5)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(80):
        lg = logits_rng.standard_normal(1000).astype(np.float32)
        assert a.pick(lg, temperature, ra) == b.pick(lg, temperature, rb)
        assert a.state == b.state and a.done == b.done
        if a.done:
            break
