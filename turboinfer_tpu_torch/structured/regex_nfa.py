"""Bounded-regex → byte-NFA compiler for JSON-Schema `pattern`.

Supports the subset patterns actually use for constrained output:
literals, '.', character classes `[a-z0-9_]` (ranges, negation),
escapes (\\d \\w \\s \\D \\W \\S and literal escapes), quantifiers
`? * + {m} {m,} {m,n}`, groups `(...)` / `(?:...)`, alternation `|`,
and `^` / `$` anchors at the pattern ends. JSON Schema patterns are
UNANCHORED (search semantics): an unanchored end gets an implicit
`.*` so the pattern may match anywhere in the string.

Thompson construction: nodes are ints; transitions are
(byte-frozenset, target) plus epsilon edges; matching runs eps-closed
frozensets of nodes — a hashable sub-state for the schema FSM's
per-state token masks. The byte alphabet is printable ASCII
(0x20..0x7E): schema-patterned strings constrain to ASCII content
with no escape sequences (documented approximation; raw control
bytes and '"'/'\\' are excluded because the JSON string layer owns
them).

No reference analog (the reference has no constrained decoding).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

_PRINTABLE = frozenset(range(0x20, 0x7F)) - {0x22, 0x5C}  # no '"' '\'
_D = frozenset(range(0x30, 0x3A))
_W = _D | frozenset(range(0x41, 0x5B)) | frozenset(range(0x61, 0x7B)) \
    | {0x5F}
_S = frozenset({0x20, 0x09})


class PatternError(ValueError):
    pass


class _Frag:
    """NFA fragment: start node + dangling accept hook (patched by
    concatenation)."""
    __slots__ = ("start", "outs")

    def __init__(self, start: int, outs: List[int]):
        self.start = start
        self.outs = outs          # node ids whose eps list gets the next


class RegexNFA:
    """Compiled pattern. match-state = frozenset of node ids
    (eps-closed); `accepting` nodes mean the content so far satisfies
    the pattern."""

    def __init__(self, pattern: str):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []
        self._pat = pattern
        self._pos = 0
        anchored_start = pattern.startswith("^")
        anchored_end = pattern.endswith("$") and not pattern.endswith(
            "\\$")
        body = pattern[1 if anchored_start else 0:
                       -1 if anchored_end else len(pattern)]
        self._pat = body
        self._pos = 0
        frag = self._alt()
        if self._pos != len(self._pat):
            raise PatternError(f"unexpected '{self._pat[self._pos]}' at "
                               f"{self._pos} in pattern {pattern!r}")
        start = frag.start
        if not anchored_start:
            # implicit leading .*: a self-looping any-byte node
            n = self._node()
            self.edges[n].append((_PRINTABLE, n))
            self.eps[n].append(frag.start)
            start = n
        acc = self._node()
        self.accept = acc
        for o in frag.outs:
            self.eps[o].append(acc)
        if not anchored_end:
            # implicit trailing .*: accept loops on any byte
            self.edges[acc].append((_PRINTABLE, acc))
        self.start_set = self._close(frozenset({start}))

    # -- construction helpers -------------------------------------------

    def _node(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def _lit_frag(self, bs: FrozenSet[int]) -> _Frag:
        n = self._node()
        m = self._node()
        self.edges[n].append((bs, m))
        return _Frag(n, [m])

    # -- recursive-descent parser ---------------------------------------

    def _peek(self) -> Optional[str]:
        return self._pat[self._pos] if self._pos < len(self._pat) else None

    def _alt(self) -> _Frag:
        frags = [self._concat()]
        while self._peek() == "|":
            self._pos += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        n = self._node()
        outs: List[int] = []
        for f in frags:
            self.eps[n].append(f.start)
            outs.extend(f.outs)
        return _Frag(n, outs)

    def _concat(self) -> _Frag:
        frags: List[_Frag] = []
        while self._peek() not in (None, "|", ")"):
            frags.append(self._quant())
        if not frags:
            n = self._node()
            return _Frag(n, [n])          # empty match
        out = frags[0]
        for f in frags[1:]:
            for o in out.outs:
                self.eps[o].append(f.start)
            out = _Frag(out.start, f.outs)
        return out

    def _quant(self) -> _Frag:
        atom_start = self._pos
        frag = self._atom()
        c = self._peek()
        if c == "?":
            self._pos += 1
            n = self._node()
            self.eps[n].append(frag.start)
            return _Frag(n, frag.outs + [n])
        if c == "*":
            self._pos += 1
            n = self._node()
            self.eps[n].append(frag.start)
            for o in frag.outs:
                self.eps[o].append(n)
            return _Frag(n, [n])
        if c == "+":
            self._pos += 1
            n = self._node()
            self.eps[n].append(frag.start)
            for o in frag.outs:
                self.eps[o].append(n)
            return _Frag(frag.start, [n])
        if c == "{":
            end = self._pat.find("}", self._pos)
            if end < 0:
                raise PatternError("unterminated {quantifier}")
            spec = self._pat[self._pos + 1: end]
            self._pos = end + 1
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s or 0)
                hi = None if hi_s == "" else int(hi_s)
            else:
                lo = hi = int(spec)
            if hi is not None and (hi < lo or hi > 256):
                raise PatternError(f"bad quantifier {{{spec}}}")
            atom_src = self._pat[atom_start:]
            return self._repeat(frag, lo, hi, atom_start)
        return frag

    def _clone_atom(self, atom_start: int) -> _Frag:
        """Re-parse the atom source to build a fresh copy (bounded
        repetition by duplication)."""
        save = self._pos
        self._pos = atom_start
        frag = self._atom()
        self._pos = save
        return frag

    def _repeat(self, frag: _Frag, lo: int, hi: Optional[int],
                atom_start: int) -> _Frag:
        if hi == 0:
            # {0} / {0,0}: zero occurrences ONLY — the atom must not be
            # reachable (wiring `frag` in accepted one occurrence).
            n0 = self._node()
            return _Frag(n0, [n0])
        parts = [frag] + [self._clone_atom(atom_start)
                          for _ in range((hi if hi is not None else lo)
                                         + (0 if hi is not None else 1)
                                         - 1)]
        # mandatory prefix lo copies, optional up to hi (or a trailing
        # loop when unbounded)
        n0 = self._node()
        cur_outs = [n0]
        outs_optional: List[int] = []
        for i, p in enumerate(parts):
            if i >= lo:
                outs_optional.extend(cur_outs)
            for o in cur_outs:
                self.eps[o].append(p.start)
            cur_outs = p.outs
        if hi is None:
            # {lo,}: loop the final copy
            loop = parts[-1]
            for o in loop.outs:
                self.eps[o].append(loop.start)
        if lo == 0:
            outs_optional.append(n0)
        return _Frag(n0, cur_outs + outs_optional)

    def _atom(self) -> _Frag:
        c = self._peek()
        if c is None:
            raise PatternError("pattern ended unexpectedly")
        if c == "(":
            self._pos += 1
            if self._pat[self._pos:self._pos + 2] == "?:":
                self._pos += 2
            f = self._alt()
            if self._peek() != ")":
                raise PatternError("unbalanced '('")
            self._pos += 1
            return f
        if c == "[":
            return self._lit_frag(self._class())
        if c == ".":
            self._pos += 1
            return self._lit_frag(_PRINTABLE)
        if c == "\\":
            self._pos += 1
            return self._lit_frag(self._escape())
        if c in ")|?*+{":
            raise PatternError(f"unexpected '{c}' at {self._pos}")
        self._pos += 1
        if c in ('"', "\\"):
            raise PatternError("'\"' and '\\\\' cannot appear in "
                               "schema-patterned string content")
        return self._lit_frag(frozenset({ord(c)}))

    def _escape(self) -> FrozenSet[int]:
        c = self._peek()
        if c is None:
            raise PatternError("dangling backslash")
        self._pos += 1
        table = {"d": _D, "D": _PRINTABLE - _D, "w": _W,
                 "W": _PRINTABLE - _W, "s": _S, "S": _PRINTABLE - _S}
        if c in table:
            return table[c]
        if c in ".^$*+?{}[]()|/-":
            return frozenset({ord(c)})
        raise PatternError(f"unsupported escape \\{c}")

    def _class(self) -> FrozenSet[int]:
        assert self._peek() == "["
        self._pos += 1
        negate = self._peek() == "^"
        if negate:
            self._pos += 1
        out: set = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise PatternError("unterminated character class")
            if c == "]" and not first:
                self._pos += 1
                break
            first = False
            if c == "\\":
                self._pos += 1
                out |= self._escape()
                continue
            self._pos += 1
            if (self._peek() == "-"
                    and self._pos + 1 < len(self._pat)
                    and self._pat[self._pos + 1] != "]"):
                self._pos += 1
                hi_c = self._pat[self._pos]
                self._pos += 1
                if ord(hi_c) < ord(c):
                    raise PatternError(f"bad range {c}-{hi_c}")
                out |= set(range(ord(c), ord(hi_c) + 1))
            else:
                out.add(ord(c))
        bs = frozenset(out)
        if negate:
            bs = _PRINTABLE - bs
        else:
            bs = bs & _PRINTABLE
        if not bs:
            raise PatternError("empty character class")
        return bs

    # -- matching --------------------------------------------------------

    def _close(self, nodes: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(nodes)
        todo = list(nodes)
        while todo:
            n = todo.pop()
            for m in self.eps[n]:
                if m not in seen:
                    seen.add(m)
                    todo.append(m)
        return frozenset(seen)

    def step(self, nodes: FrozenSet[int], b: int
             ) -> Optional[FrozenSet[int]]:
        nxt = set()
        for n in nodes:
            for bs, m in self.edges[n]:
                if b in bs:
                    nxt.add(m)
        if not nxt:
            return None
        return self._close(frozenset(nxt))

    def accepting(self, nodes: FrozenSet[int]) -> bool:
        return self.accept in nodes

    @property
    def dist_to_accept(self) -> List[float]:
        """Per-node minimum NUMBER OF BYTES to reach acceptance (eps
        edges free) — 0-1 BFS on the reversed graph, computed once.
        Lets the string layer prune prefixes that can no longer finish
        within maxLength (a patterned+bounded string would otherwise
        dead-end the grammar)."""
        d = getattr(self, "_dist", None)
        if d is not None:
            return d
        from collections import deque
        INF = float("inf")
        n_nodes = len(self.eps)
        rev_eps: List[List[int]] = [[] for _ in range(n_nodes)]
        rev_b: List[List[int]] = [[] for _ in range(n_nodes)]
        for n, ms in enumerate(self.eps):
            for m in ms:
                rev_eps[m].append(n)
        for n, es in enumerate(self.edges):
            for _bs, m in es:
                rev_b[m].append(n)
        dist = [INF] * n_nodes
        dist[self.accept] = 0
        dq = deque([self.accept])
        while dq:
            m = dq.popleft()
            for n in rev_eps[m]:
                if dist[n] > dist[m]:
                    dist[n] = dist[m]
                    dq.appendleft(n)
            for n in rev_b[m]:
                if dist[n] > dist[m] + 1:
                    dist[n] = dist[m] + 1
                    dq.append(n)
        self._dist = dist
        return dist

    def feasible(self, nodes: FrozenSet[int],
                 budget: Optional[int]) -> bool:
        """Some node can still reach acceptance within `budget` more
        bytes (None = unlimited)."""
        d = self.dist_to_accept
        best = min((d[n] for n in nodes), default=float("inf"))
        return best <= (float("inf") if budget is None else budget)
