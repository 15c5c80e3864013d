"""Byte-level JSON grammar acceptor for constrained decoding.

A pushdown automaton over BYTES (structural JSON is ASCII; arbitrary
UTF-8 bytes are legal inside strings), exposed as pure functions over
hashable states so token→state transitions can be memoized. Tracks
container nesting on an explicit stack; "done" means the single
top-level value has closed — generation stops there, guaranteeing the
emitted text parses.

No reference analog (the reference has no constrained decoding);
this backs `response_format={"type": "json_object"}` in the OpenAI
server and `InferenceEngine.generate_structured`.
"""

from __future__ import annotations

from typing import Optional, Tuple

# Modes -----------------------------------------------------------------
# Expectation modes between scalar tokens:
VALUE = "v"         # expecting start of a value
OBJ_FIRST = "of"    # inside '{': expecting '"' (first key) or '}'
OBJ_KEY = "ok"      # expecting '"' starting a key
OBJ_COLON = "oc"    # expecting ':'
OBJ_NEXT = "on"     # after a value in an object: ',' or '}'
ARR_FIRST = "af"    # inside '[': expecting a value or ']'
ARR_NEXT = "an"     # after a value in an array: ',' or ']'
DONE = "$"          # top-level value closed
# In-scalar modes (carry a sub-state payload):
STR = "s"           # inside a string: payload ("" | "\\" | "uN")
LIT = "l"           # inside true/false/null: payload = remaining chars
NUM = "n"           # inside a number: payload = number sub-state

# stack frames: "o" (object) / "a" (array); STR payload flag "k" marks
# a key string (returns to OBJ_COLON instead of container-next).

State = Tuple[str, str, Tuple[str, ...]]       # (mode, payload, stack)

_WS = b" \t\n\r"
_DIGITS = b"0123456789"
_HEX = b"0123456789abcdefABCDEF"

# Structural whitespace is bounded so a model can't stall the grammar
# by emitting newlines forever (counted per gap via a "~" payload
# suffix; whitespace inside strings is not counted).
MAX_WS_RUN = 3


def _ws_split(payload: str):
    n = len(payload) - len(payload.rstrip("~"))
    return payload[: len(payload) - n], n


def _ws_bump(mode: str, payload: str, stack) -> Optional[State]:
    base, n = _ws_split(payload)
    if n >= MAX_WS_RUN:
        return None
    return (mode, base + "~" * (n + 1), stack)


def initial(require_object: bool = True) -> State:
    """Start state. require_object=True (OpenAI json_object semantics)
    only admits a top-level {...}."""
    return (VALUE, "obj" if require_object else "", ())


def done(state: State) -> bool:
    return state[0] == DONE


def _after_value(stack: Tuple[str, ...]) -> State:
    if not stack:
        return (DONE, "", ())
    return (OBJ_NEXT if stack[-1] == "o" else ARR_NEXT, "", stack)


def _value_start(b: int, payload: str, stack: Tuple[str, ...]
                 ) -> Optional[State]:
    c = chr(b)
    if payload == "obj" and c != "{" and c not in " \t\n\r":
        return None                      # top level must be an object
    if c == "{":
        return (OBJ_FIRST, "", stack + ("o",))
    if c == "[":
        return (ARR_FIRST, "", stack + ("a",))
    if c == '"':
        return (STR, "", stack)
    if c == "t":
        return (LIT, "rue", stack)
    if c == "f":
        return (LIT, "alse", stack)
    if c == "n":
        return (LIT, "ull", stack)
    if c == "-":
        return (NUM, "-", stack)
    if c == "0":
        return (NUM, "0", stack)
    if b in _DIGITS:
        return (NUM, "i", stack)        # 1-9: integer digits
    return None


def _num_advance(b: int, sub: str, stack: Tuple[str, ...]
                 ) -> Optional[State]:
    """Number sub-states: '-' sign seen; '0' leading zero; 'i' int
    digits; '.' dot seen; 'f' fraction digits; 'e' exp marker seen;
    'es' exp sign seen; 'ed' exp digits. A number only ends at a
    delimiter, handled by the caller when the sub-state is terminal."""
    c = chr(b)
    if sub == "-":
        if c == "0":
            return (NUM, "0", stack)
        if b in _DIGITS:
            return (NUM, "i", stack)
        return None
    if sub in ("0", "i"):
        if sub == "i" and b in _DIGITS:
            return (NUM, "i", stack)
        if c == ".":
            return (NUM, ".", stack)
        if c in "eE":
            return (NUM, "e", stack)
        return "END"                     # delimiter: number ended
    if sub == ".":
        return (NUM, "f", stack) if b in _DIGITS else None
    if sub == "f":
        if b in _DIGITS:
            return (NUM, "f", stack)
        if c in "eE":
            return (NUM, "e", stack)
        return "END"
    if sub == "e":
        if c in "+-":
            return (NUM, "es", stack)
        return (NUM, "ed", stack) if b in _DIGITS else None
    if sub == "es":
        return (NUM, "ed", stack) if b in _DIGITS else None
    if sub == "ed":
        return (NUM, "ed", stack) if b in _DIGITS else "END"
    return None


def _container_next(b: int, mode: str, stack: Tuple[str, ...]
                    ) -> Optional[State]:
    c = chr(b)
    if mode in (OBJ_FIRST, OBJ_KEY):
        if c == '"':
            return (STR, "k", stack)            # key string
        if c == "}" and mode == OBJ_FIRST:
            return _after_value(stack[:-1])
        return None
    if mode == OBJ_COLON:
        return (VALUE, "", stack) if c == ":" else None
    if mode == OBJ_NEXT:
        if c == ",":
            return (OBJ_KEY, "", stack)
        if c == "}":
            return _after_value(stack[:-1])
        return None
    if mode == ARR_FIRST:
        if c == "]":
            return _after_value(stack[:-1])
        return _value_start(b, "", stack)
    if mode == ARR_NEXT:
        if c == ",":
            return (VALUE, "", stack)
        if c == "]":
            return _after_value(stack[:-1])
        return None
    return None


def advance(state: State, b: int) -> Optional[State]:
    """One byte; returns the next state or None if `b` is not a legal
    continuation."""
    mode, payload, stack = state
    if mode == DONE:
        return _ws_bump(mode, payload, stack) if b in _WS else None
    if mode == STR:
        key = payload.startswith("k")
        sub = payload[1:] if key else payload
        pre = "k" if key else ""
        if sub.startswith("u"):                 # \uXXXX, 4 hex digits
            if b not in _HEX:
                return None
            left = int(sub[1:]) - 1
            return (STR, pre + (f"u{left}" if left else ""), stack)
        if sub == "\\":
            if b in b'"\\/bfnrt':
                return (STR, pre, stack)
            if b == ord("u"):
                return (STR, pre + "u4", stack)
            return None
        if b == ord('"'):
            if key:
                return (OBJ_COLON, "", stack)
            return _after_value(stack)
        if b == ord("\\"):
            return (STR, pre + "\\", stack)
        return (STR, payload, stack) if b >= 0x20 else None
    if mode == LIT:
        if payload and b == ord(payload[0]):
            rest = payload[1:]
            return (LIT, rest, stack) if rest else _after_value(stack)
        return None
    if mode == NUM:
        nxt = _num_advance(b, payload, stack)
        if nxt == "END":
            # the delimiter byte belongs to the enclosing context
            return advance(_after_value(stack), b)
        return nxt
    if mode == VALUE:
        if b in _WS:
            return _ws_bump(mode, payload, stack)
        return _value_start(b, _ws_split(payload)[0], stack)
    if b in _WS:
        return _ws_bump(mode, payload, stack)
    return _container_next(b, mode, stack)


def advance_bytes(state: State, bs: bytes) -> Optional[State]:
    for b in bs:
        state = advance(state, b)
        if state is None:
            return None
    return state


def number_can_end(state: State) -> bool:
    """True when a NUM state is at a spot where the number could stop
    (used to allow EOS/closing after a bare number — not reachable in
    json_object mode, kept for completeness)."""
    return state[0] == NUM and state[1] in ("0", "i", "f", "ed")
