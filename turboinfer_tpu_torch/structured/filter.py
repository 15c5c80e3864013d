"""Token-level constrained decoding filter over the JSON byte FSM.

Per step: rank the logits, test candidates best-first against the
grammar (token bytes must be a legal continuation of the current FSM
state), and pick greedily or sample among the valid candidates with
renormalized probabilities. Token→bytes tables and (state, token)
transitions are memoized, so steady-state filtering touches only the
top few candidates.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from turboinfer_tpu_torch.structured import json_fsm

_BYTE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def token_bytes_table(tokenizer) -> List[Optional[bytes]]:
    """token id → raw bytes the token appends to the output text, or
    None for tokens constrained decoding must never emit (specials,
    padding, filler)."""
    toks = getattr(tokenizer, "tokens", None)
    if toks is None:
        raise ValueError("tokenizer exposes no .tokens table")
    special_ids = set(getattr(tokenizer, "special_ids", ()) or ())
    for attr in ("bos_id", "eos_id", "pad_id", "unk_id"):
        tid = getattr(tokenizer, attr, None)
        if tid is not None and tid >= 0:
            special_ids.add(tid)
    added = getattr(tokenizer, "added", {}) or {}
    special_ids.update(added.values())
    byte_level = bool(getattr(tokenizer, "byte_level", False))
    u2b = getattr(tokenizer, "_u2b", None)
    rep = "▁"
    ms = getattr(tokenizer, "_metaspace", None)
    if isinstance(ms, dict):
        rep = ms.get("replacement", "▁")

    table: List[Optional[bytes]] = []
    for i, piece in enumerate(toks):
        if i in special_ids or not piece or piece.startswith("<extra_"):
            table.append(None)
            continue
        m = _BYTE_RE.match(piece)
        if m:
            table.append(bytes([int(m.group(1), 16)]))
            continue
        if byte_level and u2b:
            try:
                table.append(bytes(u2b[ch] for ch in piece))
            except KeyError:
                table.append(None)
            continue
        table.append(piece.replace(rep, " ").encode("utf-8"))
    return table


class TokenMaskCache:
    """Per-FSM-state vocab legality masks for ON-DEVICE constrained
    decoding.

    The host-loop JsonTokenFilter tests candidates one at a time against
    the grammar — fine for a standalone call, but under continuous
    batching the constraint must ride the decode step as a per-slot
    additive bias (0 legal / -1e30 illegal), computed once per state and
    cached. A byte TRIE over the token table makes the mask one DFS from
    the FSM state (each trie edge = one json_fsm.advance); the cache key
    is EXACT but bounded: a token pops one stack level per closing
    bracket (≤ max_pops over the vocab), and after its LAST pop the
    continuation mode reads one frame deeper (e.g. `},{"` — the `,`
    lands in OBJ_KEY vs VALUE depending on the parent container), so
    legality depends on at most the top (max_pops + 1) frames; states
    sharing (mode, payload, those frames, capped depth) share a mask.
    """

    def __init__(self, tokenizer, require_object: bool = True,
                 vocab_size: Optional[int] = None, fsm=None):
        """fsm: optional grammar object with initial()/advance(state,
        byte)/done(state)/mask_key(state) — e.g. a compiled
        schema_fsm.SchemaFSM. Default: the generic JSON pushdown
        (json_fsm) with its stack-compaction key."""
        self.table = token_bytes_table(tokenizer)
        self.require_object = require_object
        self.fsm = fsm
        self.V = vocab_size if vocab_size is not None else len(self.table)
        # trie node: (children {byte: node}, token ids ending here)
        root: Tuple[Dict[int, tuple], List[int]] = ({}, [])
        max_pops = 1
        for tid, bs in enumerate(self.table):
            if bs is None or tid >= self.V:
                continue
            max_pops = max(max_pops,
                           sum(1 for b in bs if b in (0x7D, 0x5D)))
            node = root
            for b in bs:
                node = node[0].setdefault(b, ({}, []))
            node[1].append(tid)
        self._root = root
        self._S = max_pops + 1
        self._masks: Dict[tuple, np.ndarray] = {}
        self._trans: Dict[Tuple[json_fsm.State, int], object] = {}

    def initial(self) -> json_fsm.State:
        if self.fsm is not None:
            return self.fsm.initial()
        return json_fsm.initial(self.require_object)

    def done(self, state: json_fsm.State) -> bool:
        if self.fsm is not None:
            return self.fsm.done(state)
        return json_fsm.done(state)

    def _advance_bytes(self, state, bs: bytes):
        if self.fsm is not None:
            return self.fsm.advance_bytes(state, bs)
        return json_fsm.advance_bytes(state, bs)

    def _advance_byte(self, state, b: int):
        if self.fsm is not None:
            return self.fsm.advance(state, b)
        return json_fsm.advance(state, b)

    def advance(self, state: json_fsm.State, tid: int):
        """state after emitting token `tid` (None = was illegal)."""
        key = (state, tid)
        if key in self._trans:
            return self._trans[key]
        bs = self.table[tid] if tid < len(self.table) else None
        nxt = self._advance_bytes(state, bs) if bs else None
        self._trans[key] = nxt
        return nxt

    def _key(self, state: json_fsm.State) -> tuple:
        if self.fsm is not None:
            return self.fsm.mask_key(state)
        mode, payload, stack = state
        S = self._S
        if len(stack) <= S:
            return (mode, payload, stack)
        # Deeper frames can neither be popped within one token (each
        # pop consumes a closing bracket; no vocab token holds more
        # than S-1) nor read by the post-pop continuation mode (that
        # reads at most one frame below the last pop, still in the top
        # S) — and the stack can't empty either, so DONE-vs-deeper
        # distinctions don't arise. Exact, not approximate.
        return (mode, payload, "deep", stack[-S:])

    def mask(self, state: json_fsm.State) -> np.ndarray:
        """[V] bool — tokens that are legal continuations of `state`."""
        key = self._key(state)
        m = self._masks.get(key)
        if m is not None:
            return m
        m = np.zeros((self.V,), bool)
        # iterative DFS over (trie node, fsm state)
        stack = [(self._root, state)]
        while stack:
            (children, ids), st = stack.pop()
            for tid in ids:
                m[tid] = True
            for b, child in children.items():
                ns = self._advance_byte(st, b)
                if ns is not None:
                    stack.append((child, ns))
        self._masks[key] = m
        return m

    def bias_row(self, state: json_fsm.State, eos_id: int,
                 illegal: float = -1e30) -> np.ndarray:
        """[V] f32 additive logit bias: 0 for legal tokens, `illegal`
        elsewhere. At DONE only EOS stays legal (generation must stop);
        if NO token is legal (unreachable for sane vocabs) EOS is
        allowed so the request can end instead of wedging."""
        if self.done(state):
            m = np.zeros((self.V,), bool)
        else:
            m = self.mask(state)
        row = np.where(m, 0.0, illegal).astype(np.float32)
        if not m.any() and 0 <= eos_id < self.V:
            row[eos_id] = 0.0
        if (self.fsm is not None and 0 <= eos_id < self.V
                and getattr(self.fsm, "may_finish", None)
                and self.fsm.may_finish(state)):
            # states where stopping is ALSO valid (e.g. a top-level
            # number at a terminal digit): EOS stays legal alongside
            # the continuations
            row[eos_id] = 0.0
        return row


class JsonTokenFilter:
    """Stateful per-request grammar constraint (generic JSON pushdown
    by default; pass `fsm` — e.g. a compiled schema_fsm.SchemaFSM —
    for schema-directed output)."""

    def __init__(self, tokenizer, require_object: bool = True,
                 max_candidates: int = 512, fsm=None, eos_id=None):
        """eos_id: when given and the grammar reaches a MAY-finish
        state (fsm.may_finish — e.g. a top-level number at a terminal
        digit), the EOS token competes with the legal continuations in
        pick(); choosing it ends the generation. Without it a
        top-level number grammar could never finish on the host path
        (done() is strict)."""
        self.table = token_bytes_table(tokenizer)
        self.require_object = require_object
        self.max_candidates = max_candidates
        self.fsm = fsm
        self.eos_id = eos_id
        self._stopped = False
        self.state = (fsm.initial() if fsm is not None
                      else json_fsm.initial(require_object))
        # (state, token id) -> next state (None = illegal)
        self._trans: Dict[Tuple[json_fsm.State, int], object] = {}

    def reset(self):
        self._stopped = False
        self.state = (self.fsm.initial() if self.fsm is not None
                      else json_fsm.initial(self.require_object))

    @property
    def done(self) -> bool:
        if self._stopped:
            return True
        if self.fsm is not None:
            return self.fsm.done(self.state)
        return json_fsm.done(self.state)

    def _may_stop(self) -> bool:
        return (self.eos_id is not None and self.fsm is not None
                and getattr(self.fsm, "may_finish", None) is not None
                and self.fsm.may_finish(self.state))

    def _next_state(self, tid: int):
        key = (self.state, tid)
        if key in self._trans:
            return self._trans[key]
        bs = self.table[tid] if tid < len(self.table) else None
        if bs is None:
            nxt = None
        elif self.fsm is not None:
            nxt = self.fsm.advance_bytes(self.state, bs)
        else:
            nxt = json_fsm.advance_bytes(self.state, bs)
        self._trans[key] = nxt
        return nxt

    def pick(self, logits: np.ndarray, temperature: float = 0.0,
             rng: Optional[np.random.Generator] = None) -> Optional[int]:
        """Choose the next token from [V] logits under the grammar and
        advance. Returns None only if NO vocab token is legal (never
        happens for sane vocabs — strings accept almost every byte)."""
        V = logits.shape[-1]
        K = min(self.max_candidates, V)
        # best-first candidate order without a full sort
        part = np.argpartition(logits, -K)[-K:]
        order = part[np.argsort(logits[part])[::-1]]
        may_stop = self._may_stop()
        valid: List[int] = []
        states = {}
        for tid in order:
            if may_stop and int(tid) == self.eos_id:
                # stopping competes with the continuations
                if temperature <= 0.0:
                    self._stopped = True
                    return int(tid)
                valid.append(int(tid))
                states[int(tid)] = "STOP"
                if len(valid) >= 64:
                    break
                continue
            nxt = self._next_state(int(tid))
            if nxt is None:
                continue
            if temperature <= 0.0:
                self.state = nxt
                return int(tid)
            valid.append(int(tid))
            states[int(tid)] = nxt
            if len(valid) >= 64:          # plenty for sampling
                break
        if not valid:
            # fall back: scan the whole vocab once (rare)
            for tid in np.argsort(logits)[::-1]:
                nxt = self._next_state(int(tid))
                if nxt is not None:
                    self.state = nxt
                    return int(tid)
            return None
        x = logits[valid].astype(np.float64) / max(temperature, 1e-6)
        x -= x.max()
        p = np.exp(x)
        p /= p.sum()
        choice = int((rng or np.random.default_rng()).choice(valid, p=p))
        if states[choice] == "STOP":
            self._stopped = True
            return choice
        self.state = states[choice]
        return choice
