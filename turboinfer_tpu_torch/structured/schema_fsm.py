"""JSON-SCHEMA-directed byte acceptor for constrained decoding.

Compiles a user-supplied JSON Schema (the subset users actually
constrain with) into a flat byte-level program whose states are
hashable tuples — the same contract as the generic json_fsm, so
TokenMaskCache can build per-state vocab masks and the scheduler
applies them as device slot biases.

Coverage:
  - objects with required AND optional properties (emission order is
    declaration order; optional keys may be skipped — a choice at each
    key boundary);
  - anyOf / oneOf (alternatives run as an NFA set of program states;
    oneOf is treated as anyOf — exclusivity of overlapping branches is
    not enforced, documented approximation);
  - string / number / integer / boolean / null leaves, enums, const;
  - integer minimum/maximum/exclusive* bounds (the value prefix is
    tracked exactly; a digit is legal only while some in-range
    completion remains — no dead ends);
  - string minLength/maxLength and `pattern` (bounded regex subset
    compiled to a byte NFA, see structured/regex_nfa.py; patterned
    string content is printable ASCII with no escape sequences);
  - nested objects and bounded arrays.

Output shape: canonical compact JSON, no whitespace. Every accept path
of the automaton is a document that validates against the schema (for
the supported subset).

Unsupported keywords raise SchemaError at compile time — honest errors
over silent drift. No reference analog (the reference has no
constrained decoding at all).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

_DIGITS = b"0123456789"
_HEX = b"0123456789abcdefABCDEF"

# default cap for arrays with no maxItems: the grammar must stay finite
DEFAULT_MAX_ITEMS = 64
# longest number literal the grammar admits (bounds generation length)
MAX_NUM_LEN = 24


class SchemaError(ValueError):
    pass


# State = (pc, sub, stack)
#   pc: index into the instruction program
#   sub: in-instruction progress (lit position, string/number payload,
#        viable-choice tuple)
#   stack: tuple of [open_pc, items_done] pairs for nested arrays
# or ("NFA", frozenset of such states) when anyOf branches are live.
State = Tuple[int, Any, Tuple]


class SchemaFSM:
    """Compiled schema program. Instructions:
    ("lit", bytes)                fixed bytes (keys, punctuation)
    ("str", min, max, nfa)        JSON string incl. quotes (nfa: compiled
                                  pattern or None)
    ("num", int_only, lo, hi)     JSON number (integer: no . / e;
                                  lo/hi: integer bounds or None)
    ("choice", (bytes, ...))      one of N rendered literals (enums)
    ("obj", entries, after_pc)    object with optional keys; entries =
                                  ((key_lit, value_pc, required), ...)
    ("obj_next", open_pc, idx)    after a value: ',' next key or '}'
    ("alt", (pc, ...), after_pc)  anyOf/oneOf branch entry (NFA fanout)
    ("goto", pc)                  jump (alt branch epilogue)
    ("arr_open", min, max, body_pc, after_pc)
    ("arr_sep", open_pc)          after an item: ',' more or ']' close
    ("end",)                      document complete
    """

    def __init__(self, schema: Dict[str, Any]):
        self.prog: List[tuple] = []
        self._compile(schema)
        self.prog.append(("end",))

    # -- compilation ----------------------------------------------------

    def _lit(self, bs: bytes):
        # merge adjacent literals so lit positions stay small (the
        # None check matters: an arr_open placeholder may precede us —
        # array-of-objects crashed here before)
        if (self.prog and self.prog[-1] is not None
                and self.prog[-1][0] == "lit"):
            self.prog[-1] = ("lit", self.prog[-1][1] + bs)
        else:
            self.prog.append(("lit", bs))

    def _compile(self, schema: Dict[str, Any]):
        if not isinstance(schema, dict):
            raise SchemaError(f"schema must be an object, got "
                              f"{type(schema).__name__}")
        if "$ref" in schema:
            raise SchemaError("$ref is not supported")
        if "anyOf" in schema or "oneOf" in schema:
            alts = schema.get("anyOf") or schema.get("oneOf")
            if not isinstance(alts, list) or not alts:
                raise SchemaError("anyOf/oneOf must be a non-empty list")
            open_pc = len(self.prog)
            self.prog.append(None)               # ("alt", ...) patched
            branch_pcs: List[int] = []
            goto_pcs: List[int] = []
            for a in alts:
                branch_pcs.append(len(self.prog))
                self._compile(a)
                goto_pcs.append(len(self.prog))
                self.prog.append(None)           # ("goto", after) patched
            after_pc = len(self.prog)
            self.prog[open_pc] = ("alt", tuple(branch_pcs), after_pc)
            for g in goto_pcs:
                self.prog[g] = ("goto", after_pc)
            return
        if "enum" in schema:
            alts = tuple(json.dumps(v, ensure_ascii=True,
                                    separators=(",", ":")).encode()
                         for v in schema["enum"])
            if len(set(alts)) != len(alts) or not alts:
                raise SchemaError("enum must be non-empty and distinct")
            for a in alts:
                for b in alts:
                    if a != b and b.startswith(a):
                        raise SchemaError(
                            f"enum literal {a!r} is a prefix of {b!r}; "
                            "ambiguous under byte-level constraint")
            self.prog.append(("choice", alts))
            return
        if "const" in schema:
            self._lit(json.dumps(schema["const"], ensure_ascii=True,
                                 separators=(",", ":")).encode())
            return
        t = schema.get("type")
        if isinstance(t, list):
            raise SchemaError("union types are not supported")
        if t == "object":
            props = schema.get("properties") or {}
            required = schema.get("required")
            if required is not None:
                missing = [k for k in required if k not in props]
                if missing:
                    raise SchemaError(f"required keys {missing} not in "
                                      "properties")
            req = {k: (required is None or k in required) for k in props}
            if all(req.values()):
                # all-required: the linear literal layout (merged lits
                # keep mask states few — the plain fast shape)
                self._lit(b"{")
                for i, k in enumerate(props):
                    if i:
                        self._lit(b",")
                    self._lit(json.dumps(k, ensure_ascii=True).encode()
                              + b":")
                    self._compile(props[k])
                self._lit(b"}")
                return
            # optional properties: the obj instruction — a choice at
            # each key boundary, declaration order preserved
            open_pc = len(self.prog)
            self.prog.append(None)
            entries = []
            for idx, (k, sub) in enumerate(props.items()):
                lit = json.dumps(k, ensure_ascii=True).encode() + b":"
                value_pc = len(self.prog)
                self._compile(sub)
                self.prog.append(("obj_next", open_pc, idx))
                entries.append((lit, value_pc, req[k]))
            after_pc = len(self.prog)
            self.prog[open_pc] = ("obj", tuple(entries), after_pc)
            return
        if t == "string":
            mn = int(schema.get("minLength", 0))
            mx = schema.get("maxLength")
            mx = None if mx is None else int(mx)
            if mx is not None and (mx < mn or mx < 0):
                raise SchemaError(f"bad string bounds [{mn}, {mx}]")
            nfa = None
            if schema.get("pattern") is not None:
                from turboinfer_tpu_torch.structured.regex_nfa import (
                    PatternError, RegexNFA)
                try:
                    nfa = RegexNFA(str(schema["pattern"]))
                except PatternError as e:
                    raise SchemaError(f"unsupported pattern: {e}")
                if not nfa.feasible(nfa.start_set, mx):
                    raise SchemaError(
                        f"pattern {schema['pattern']!r} cannot match "
                        f"within maxLength {mx}")
            self.prog.append(("str", mn, mx, nfa))
            return
        if t in ("number", "integer"):
            lo = schema.get("minimum")
            hi = schema.get("maximum")
            # exclusive bounds may be fractional (e.g. 0.5): the
            # smallest integer > x is floor(x)+1 and the largest < x is
            # ceil(x)-1 — int() truncation got both wrong for the
            # fraction/negative cases (exclusiveMaximum=0.5 forbade 0).
            import math
            if schema.get("exclusiveMinimum") is not None:
                lo = math.floor(schema["exclusiveMinimum"]) + 1
            if schema.get("exclusiveMaximum") is not None:
                hi = math.ceil(schema["exclusiveMaximum"]) - 1
            if lo is None and hi is None:
                self.prog.append(("num", t == "integer", None, None))
                return
            if t != "integer":
                raise SchemaError(
                    "minimum/maximum bounds are supported for "
                    "type 'integer' only (float bounds cannot be "
                    "enforced byte-exactly)")
            for v in (lo, hi):
                if v is not None and int(v) != v:
                    raise SchemaError("integer bounds must be integers")
            lo = -(10 ** (MAX_NUM_LEN - 2)) if lo is None else int(lo)
            hi = 10 ** (MAX_NUM_LEN - 2) if hi is None else int(hi)
            if hi < lo:
                raise SchemaError(f"bad integer bounds [{lo}, {hi}]")
            self.prog.append(("num", True, lo, hi))
            return
        if t == "boolean":
            self.prog.append(("choice", (b"true", b"false")))
            return
        if t == "null":
            self._lit(b"null")
            return
        if t == "array":
            mn = int(schema.get("minItems", 0))
            mx = int(schema.get("maxItems", DEFAULT_MAX_ITEMS))
            if mx < mn or mx < 0:
                raise SchemaError(f"bad array bounds [{mn}, {mx}]")
            items = schema.get("items")
            if items is None:
                raise SchemaError("array needs an 'items' schema")
            open_pc = len(self.prog)
            self.prog.append(None)               # patched below
            body_pc = len(self.prog)
            self._compile(items)
            self.prog.append(("arr_sep", open_pc))
            after_pc = len(self.prog)
            self.prog[open_pc] = ("arr_open", mn, mx, body_pc, after_pc)
            return
        raise SchemaError(f"unsupported schema node: "
                          f"{json.dumps(schema)[:80]}")

    # -- runtime --------------------------------------------------------

    def initial(self) -> State:
        return self._enter(0, ())

    def done(self, state: State) -> bool:
        """The document is COMPLETE — nothing may follow."""
        if state[0] == "NFA":
            return all(self.done(m) for m in state[1])
        return self.prog[state[0]][0] == "end"

    def may_finish(self, state: State) -> bool:
        """The document WOULD be valid if generation stopped here (a
        top-level number at a terminal digit can either continue or
        end; an anyOf with one completed and one live branch). bias_row
        leaves EOS legal at such states ALONGSIDE the continuations —
        done() used to claim these states were final, which froze
        top-level numbers after their first token."""
        if state[0] == "NFA":
            return (not self.done(state)
                    and any(self.done(m) or self.may_finish(m)
                            for m in state[1]))
        pc, sub, stack = state
        ins = self.prog[pc]
        if ins[0] != "num" or not isinstance(sub, tuple) or stack:
            return False
        if not self._at_top_level(pc):
            return False
        if ins[2] is not None:                    # bounded integer
            return (sub[0] == "bi"
                    and ins[2] <= sub[1] <= ins[3])
        return sub[0] in ("0", "i", "f", "ed")

    def _at_top_level(self, pc: int) -> bool:
        """Whether completing the instruction at pc ends the document
        (pc+1 is "end", possibly through gotos)."""
        nxt = pc + 1
        while self.prog[nxt][0] == "goto":
            nxt = self.prog[nxt][1]
        return self.prog[nxt][0] == "end"

    def mask_key(self, state: State):
        """Canonical key for mask caching. Free-string body states with
        no maxLength are collapsed once past minLength (their legal
        token set no longer depends on the exact count) — otherwise a
        long unbounded string would mint a fresh full-vocab mask per
        generated token and grow the cache without bound. Patterned
        strings additionally key on the NFA node set (which IS the
        legal-byte-set determinant)."""
        if state[0] == "NFA":
            return ("NFA", frozenset(self.mask_key(m) for m in state[1]))
        pc, sub, stack = state
        ins = self.prog[pc]
        if (ins[0] == "str" and isinstance(sub, tuple)
                and sub[0] in ("b", "p")
                and ins[2] is None and sub[1] >= ins[1]):
            if sub[0] == "p":
                return (pc, ("p", ins[1], sub[2]), stack)
            return (pc, (sub[0], ins[1]), stack)
        return state

    def _enter(self, pc: int, stack: Tuple) -> State:
        """Fresh state at instruction pc (normalizing choice sub,
        following gotos, fanning out alt branches to an NFA set)."""
        while self.prog[pc][0] == "goto":
            pc = self.prog[pc][1]
        ins = self.prog[pc]
        if ins[0] == "choice":
            return (pc, (0, tuple(range(len(ins[1])))), stack)
        if ins[0] == "alt":
            members = []
            for bpc in ins[1]:
                m = self._enter(bpc, stack)
                if m[0] == "NFA":
                    members.extend(m[1])
                else:
                    members.append(m)
            return ("NFA", frozenset(members))
        if ins[0] == "str" and ins[3] is not None:
            return (pc, "", stack)
        return (pc, "", stack)

    def _obj_allowed(self, entries, i: int) -> Tuple[int, ...]:
        """Key indices that may come next starting from index i: every
        optional key up to and including the first required one."""
        out = []
        for j in range(i, len(entries)):
            out.append(j)
            if entries[j][2]:
                break
        return tuple(out)

    def _obj_may_close(self, entries, i: int) -> bool:
        """'}' legal when no required key remains at or after i."""
        return not any(e[2] for e in entries[i:])

    @staticmethod
    def _int_feasible(v: int, more: int, lo: int, hi: int) -> bool:
        """Can the integer prefix with value v, extended by up to
        `more` digits (or stopped now), land in [lo, hi]?"""
        for j in range(0, more + 1):
            p = 10 ** j
            if v >= 0:
                a, b = v * p, v * p + (p - 1)
            else:
                a, b = v * p - (p - 1), v * p
            if b >= lo and a <= hi:
                return True
        return False

    def advance(self, state: State, b: int) -> Optional[State]:
        if state[0] == "NFA":
            members = []
            for m in state[1]:
                n = self.advance(m, b)
                if n is None:
                    continue
                if n[0] == "NFA":
                    members.extend(n[1])
                else:
                    members.append(n)
            if not members:
                return None
            if len(set(members)) == 1:
                return members[0]
            return ("NFA", frozenset(members))
        pc, sub, stack = state
        ins = self.prog[pc]
        kind = ins[0]

        if kind == "end":
            return None

        if kind == "lit":
            pos = sub if isinstance(sub, int) else 0
            if ins[1][pos] != b:
                return None
            pos += 1
            if pos == len(ins[1]):
                return self._enter(pc + 1, stack)
            return (pc, pos, stack)

        if kind == "str" and ins[3] is not None:
            # patterned string: sub = ("p", n, nfa_nodes). Content is
            # printable ASCII, no escapes; '"' closes when the NFA
            # accepts and n >= minLength.
            mn, mx, nfa = ins[1], ins[2], ins[3]
            if sub == "":
                return ((pc, ("p", 0, nfa.start_set), stack)
                        if b == 0x22 else None)
            _, n, nodes = sub
            if b == 0x22:
                return (self._enter(pc + 1, stack)
                        if n >= mn and nfa.accepting(nodes) else None)
            if mx is not None and n >= mx:
                return None
            nxt = nfa.step(nodes, b)
            if nxt is None:
                return None
            # prune prefixes that can no longer reach acceptance within
            # maxLength — a byte that wedges the grammar is not legal
            if not nfa.feasible(nxt, None if mx is None
                                else mx - (n + 1)):
                return None
            return (pc, ("p", n + 1, nxt), stack)

        if kind == "str":
            # sub: "" start (expect '"'); ("b", n) body with n content
            # chars so far; ("\\", n) escape; ("uK", n) unicode escape
            # with K hex digits left. minLength/maxLength bound n (an
            # escape sequence counts as one char; raw multi-byte UTF-8
            # counts per byte — documented approximation).
            mn, mx = ins[1], ins[2]
            if sub == "":
                return (pc, ("b", 0), stack) if b == 0x22 else None
            tag, n = sub
            if tag.startswith("u"):
                if b not in _HEX:
                    return None
                left = int(tag[1:]) - 1
                return (pc, (f"u{left}", n) if left else ("b", n + 1),
                        stack)
            if tag == "\\":
                if b in b'"\\/bfnrt':
                    return (pc, ("b", n + 1), stack)
                if b == ord("u"):
                    return (pc, ("u4", n), stack)
                return None
            if b == 0x22:                         # closing quote
                return self._enter(pc + 1, stack) if n >= mn else None
            if mx is not None and n >= mx:
                return None                       # only '"' may follow
            if b == 0x5C:                         # backslash
                return (pc, ("\\", n), stack)
            return (pc, ("b", n + 1), stack) if b >= 0x20 else None

        if kind == "num" and ins[2] is not None:
            # bounded integer: track the exact value; a digit stays
            # legal only while some in-range completion remains.
            lo, hi = ins[2], ins[3]
            c = chr(b)
            if sub == "":
                if c == "-":
                    return (pc, ("b-",), stack) if lo < 0 else None
                if c == "0":
                    return ((pc, ("bi", 0, 1, False), stack)
                            if lo <= 0 <= hi else None)
                if b in _DIGITS:
                    v = int(c)
                    if self._int_feasible(v, MAX_NUM_LEN - 1, lo, hi):
                        return (pc, ("bi", v, 1, True), stack)
                return None
            if sub[0] == "b-":
                if c == "0":
                    return ((pc, ("bi", 0, 2, False), stack)
                            if lo <= 0 <= hi else None)
                if b in _DIGITS and c != "0":
                    v = -int(c)
                    if self._int_feasible(v, MAX_NUM_LEN - 2, lo, hi):
                        return (pc, ("bi", v, 2, True), stack)
                return None
            _, v, n, ext = sub
            if b in _DIGITS and ext and n < MAX_NUM_LEN:
                d = int(c)
                v2 = v * 10 + (d if v >= 0 else -d)
                if v == 0:
                    return None          # leading zero (0 / -0 final)
                if self._int_feasible(v2, MAX_NUM_LEN - n - 1, lo, hi):
                    return (pc, ("bi", v2, n + 1, True), stack)
                return None
            if lo <= v <= hi:
                # delimiter byte belongs to the next instruction
                return self.advance(self._enter(pc + 1, stack), b)
            return None

        if kind == "num":
            from turboinfer_tpu_torch.structured.json_fsm import _num_advance
            int_only = ins[1]
            c = chr(b)
            if sub == "":
                if c == "-":
                    return (pc, ("-", 1), stack)
                if c == "0":
                    return (pc, ("0", 1), stack)
                if b in _DIGITS:
                    return (pc, ("i", 1), stack)
                return None
            s, n = sub
            if int_only and c in ".eE":
                return None
            nxt = _num_advance(b, s, ())
            if nxt == "END":
                # delimiter byte belongs to the next instruction
                return self.advance(self._enter(pc + 1, stack), b)
            if nxt is None or n >= MAX_NUM_LEN:
                return None        # length cap keeps the grammar finite
            return (pc, (nxt[1], n + 1), stack)

        if kind == "choice":
            pos, viable = sub if isinstance(sub, tuple) else (
                0, tuple(range(len(ins[1]))))
            nxt_viable = tuple(i for i in viable
                               if len(ins[1][i]) > pos
                               and ins[1][i][pos] == b)
            if not nxt_viable:
                return None
            # compile-time prefix check guarantees at most one
            # alternative completes, and none remain viable past it
            for i in nxt_viable:
                if len(ins[1][i]) == pos + 1:
                    return self._enter(pc + 1, stack)
            return (pc, (pos + 1, nxt_viable), stack)

        if kind == "obj":
            entries, after_pc = ins[1], ins[2]
            if sub == "":
                if b != 0x7B:                    # '{'
                    return None
                # '}' may follow ONLY here (empty object) — a comma
                # key-choice state must not accept it (trailing comma)
                can_close = self._obj_may_close(entries, 0)
                return (pc, ("key", 0, self._obj_allowed(entries, 0),
                             can_close), stack)
            tag, pos, viable, can_close = sub
            if pos == 0 and b == 0x7D:           # '}' straight away
                return (self._enter(after_pc, stack) if can_close
                        else None)
            nxt = tuple(j for j in viable
                        if len(entries[j][0]) > pos
                        and entries[j][0][pos] == b)
            if not nxt:
                return None
            for j in nxt:
                if len(entries[j][0]) == pos + 1:
                    return self._enter(entries[j][1], stack)
            return (pc, ("key", pos + 1, nxt, False), stack)

        if kind == "obj_next":
            open_pc, idx = ins[1], ins[2]
            entries, after_pc = self.prog[open_pc][1:]
            if b == 0x2C:                        # ','
                allowed = self._obj_allowed(entries, idx + 1)
                if not allowed:
                    return None
                return (open_pc, ("key", 0, allowed, False), stack)
            if b == 0x7D:                        # '}'
                return (self._enter(after_pc, stack)
                        if self._obj_may_close(entries, idx + 1)
                        else None)
            return None

        if kind == "arr_open":
            mn, mx, body_pc, after_pc = ins[1:]
            if sub == "":
                if b != 0x5B:                    # '['
                    return None
                return (pc, "in", stack)
            # sub == "in": expecting first item or ']'
            if b == 0x5D and mn == 0:            # ']'
                return self._enter(after_pc, stack)
            if mx == 0:
                return None
            st = self._enter(body_pc, stack + ((pc, 0),))
            return self.advance(st, b)

        if kind == "arr_sep":
            open_pc = ins[1]
            mn, mx, body_pc, after_pc = self.prog[open_pc][1:]
            top_pc, n_done = stack[-1]
            assert top_pc == open_pc
            done_items = n_done + 1
            if b == 0x2C:                        # ','
                if done_items >= mx:
                    return None
                return self._enter(body_pc,
                                   stack[:-1] + ((open_pc, done_items),))
            if b == 0x5D:                        # ']'
                if done_items < mn:
                    return None
                return self._enter(after_pc, stack[:-1])
            return None

        raise AssertionError(f"bad instruction {ins}")

    def advance_bytes(self, state: State, bs: bytes) -> Optional[State]:
        for b in bs:
            state = self.advance(state, b)
            if state is None:
                return None
        return state
