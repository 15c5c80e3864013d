"""HuggingFace `tokenizer.json` loader (fast-tokenizer format); the
counterpart of turboinfer_tpu/tokenizer/hf.py, id for id.

Safetensors checkpoints ship their vocab as a tokenizer.json sidecar
(not GGUF metadata); this module reads it for HF checkpoint
directories (loader._finish_hf_load attaches it).

Supported `model.type`s:
  - BPE: merge-rank byte-pair encoding with optional byte-level
    alphabet (GPT-2/Qwen/Llama-3), Metaspace/"▁" pretokenization
    (Llama-1/2, Mistral, Phi-3), byte_fallback, ignore_merges
    (Llama-3), fuse_unk.
  - Unigram: Viterbi segmentation over log-prob vocab (Gemma, T5),
    with byte fallback and unk fusing.

Pretokenization honors the file's pre_tokenizer chain: Split regex
patterns and ByteLevel (GPT-2 regex + byte->unicode alphabet), both
through the `regex` module (HF patterns use \\p{L} classes), Metaspace,
Digits, and legacy normalizer chains (Prepend "▁", Replace " "->"▁").
`regex` is imported only where a pattern needs it: Metaspace BPE and
Unigram files load without it, and a ByteLevel or Split file raises
ImportError naming `regex`. added_tokens are split out first and
emitted verbatim.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from turboinfer_tpu_torch.tokenizer.bpe import Tokenizer, _bytes_to_unicode, \
    bpe_merge

# The GPT-2 pretokenization pattern (what ByteLevel(use_regex=True)
# applies); requires the `regex` module for \p classes.
_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
               r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _flatten_chain(node: Optional[Dict[str, Any]], key: str
                   ) -> List[Dict[str, Any]]:
    """Flatten a {type: Sequence, <key>: [...]} chain into a list."""
    if not node:
        return []
    if node.get("type") == "Sequence":
        out: List[Dict[str, Any]] = []
        for sub in node.get(key, node.get("normalizers", [])) or []:
            out.extend(_flatten_chain(sub, key))
        return out
    return [node]


class HFTokenizer(Tokenizer):
    """Tokenizer built from a parsed tokenizer.json dict."""

    def __init__(self, tj: Dict[str, Any],
                 bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 pad_id: int = -1):
        model = tj["model"]
        self.kind = model["type"]
        if self.kind not in ("BPE", "Unigram"):
            raise ValueError(
                f"unsupported tokenizer.json model type '{self.kind}' "
                "(supported: BPE, Unigram)")

        # --- vocab ----------------------------------------------------
        if self.kind == "BPE":
            vocab: Dict[str, int] = dict(model["vocab"])
            self.scores: Dict[str, float] = {}
        else:                                     # Unigram: [[tok, score]]
            vocab = {}
            self.scores = {}
            for i, (tok, score) in enumerate(model["vocab"]):
                vocab[tok] = i
                self.scores[tok] = float(score)
        self.vocab = vocab
        size = max(vocab.values()) + 1 if vocab else 0

        # --- added tokens (specials, chat tokens) ----------------------
        self.added: Dict[str, int] = {}
        self.special_ids: set = set()
        for t in tj.get("added_tokens", []) or []:
            self.added[t["content"]] = int(t["id"])
            size = max(size, int(t["id"]) + 1)
            if t.get("special"):
                self.special_ids.add(int(t["id"]))
        self.vocab_size = size
        self.tokens: List[str] = [""] * size
        for tok, i in vocab.items():
            self.tokens[i] = tok
        for tok, i in self.added.items():
            self.tokens[i] = tok
        # longest-first so overlapping added tokens match greedily
        self._added_sorted = sorted(self.added, key=len, reverse=True)

        # --- BPE merge ranks -------------------------------------------
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(model.get("merges", []) or []):
            if isinstance(m, str):
                a, _, b = m.partition(" ")
            else:
                a, b = m
            self.ranks[(a, b)] = r
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.fuse_unk = bool(model.get("fuse_unk"))
        unk_tok = model.get("unk_token")
        if self.kind == "Unigram":
            uid = model.get("unk_id")
            self.unk_id = int(uid) if uid is not None else 0
            self.fuse_unk = True       # sentencepiece semantics: always fuse
        else:
            # unk_token=None (GPT-2/Llama-3 byte-level vocabs cover every
            # byte): unknown segments are DROPPED, matching HF.
            self.unk_id = vocab.get(unk_tok) if unk_tok else None
        self._min_score = min(self.scores.values(), default=0.0)
        self._max_tok_len = max((len(t) for t in vocab), default=1)

        # --- normalizer chain (legacy Llama SPM style) ------------------
        self._prepend: Optional[str] = None
        self._replace: List[Tuple[str, str]] = []
        for n in _flatten_chain(tj.get("normalizer"), "normalizers"):
            t = n.get("type")
            if t == "Prepend":
                self._prepend = n.get("prepend", "▁")
            elif t == "Replace":
                pat = n.get("pattern", {})
                src = pat.get("String") if isinstance(pat, dict) else pat
                if src is not None:
                    self._replace.append((src, n.get("content", "")))
            # NFC/NFKC/Lowercase etc. intentionally not applied: the
            # model families we run don't use them.

        # --- pre_tokenizer chain ----------------------------------------
        self.byte_level = False
        self._bl_prefix_space = False
        self._metaspace: Optional[Dict[str, Any]] = None
        self._splits: List[Tuple[Any, str]] = []       # (compiled, behavior)
        self._digits_individual = False
        for p in _flatten_chain(tj.get("pre_tokenizer"), "pretokenizers"):
            t = p.get("type")
            if t == "ByteLevel":
                self.byte_level = True
                self._bl_prefix_space = bool(p.get("add_prefix_space"))
                if p.get("use_regex", True):
                    self._splits.append((_compile(_GPT2_SPLIT), "isolated"))
            elif t == "Metaspace":
                self._metaspace = p
            elif t == "Split":
                pat = p.get("pattern", {})
                rx = (pat.get("Regex") if isinstance(pat, dict)
                      else None) or (pat.get("String") and
                                     _escape(pat["String"]))
                if rx:
                    # file order == application order (HF Sequence
                    # semantics; chained Split entries must not swap)
                    self._splits.append(
                        (_compile(rx),
                         str(p.get("behavior", "Isolated")).lower()))
            elif t == "Digits":
                self._digits_individual = bool(p.get("individual_digits"))

        self._b2u = _bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}

        # -1 sentinel when the vocab carries no bos/eos: never matches a
        # real token (defaulting to 0 would silently skip token 0 in
        # decode and stop generation on it).
        self.bos_id = bos_id if bos_id is not None else self.vocab.get(
            "<s>", self.added.get("<s>", -1))
        self.eos_id = eos_id if eos_id is not None else self.vocab.get(
            "</s>", self.added.get("</s>", -1))
        self.pad_id = pad_id

    # -- pretokenization -----------------------------------------------

    def _pretokenize(self, text: str,
                     metaspace: Optional[Dict[str, Any]] = None
                     ) -> List[str]:
        """Normalizers + pre_tokenizer chain → pieces the model encodes
        independently. `metaspace` overrides self._metaspace (encode()
        passes a chunk-local variant for prepend_scheme='first' — must
        not mutate shared state, encode is called from server handler
        threads concurrently)."""
        if self._prepend and text and not text.startswith(self._prepend):
            text = self._prepend + text
        for src, dst in self._replace:
            text = text.replace(src, dst)

        pieces = [text]
        for rx, behavior in self._splits:
            nxt: List[str] = []
            for piece in pieces:
                # "isolated": keep matches as their own pieces; "removed":
                # drop them. Unmatched gaps survive in both behaviors.
                last = 0
                for m in rx.finditer(piece):
                    if m.start() > last:
                        nxt.append(piece[last:m.start()])
                    if behavior != "removed" and m.group(0):
                        nxt.append(m.group(0))
                    last = m.end()
                if last < len(piece):
                    nxt.append(piece[last:])
            pieces = nxt

        ms = self._metaspace if metaspace is None else metaspace
        if ms is not None:
            rep = ms.get("replacement", "▁")
            scheme = ms.get("prepend_scheme",
                            "always" if ms.get("add_prefix_space", True)
                            else "never")
            out: List[str] = []
            for piece in pieces:
                piece = piece.replace(" ", rep)
                if scheme == "always" or (scheme == "first" and not out):
                    if not piece.startswith(rep):
                        piece = rep + piece
                # split so each pretoken starts at a ▁ boundary
                segs: List[str] = []
                cur = ""
                for ch in piece:
                    if ch == rep and cur and not cur.endswith(rep):
                        segs.append(cur)
                        cur = ch
                    else:
                        cur += ch
                if cur:
                    segs.append(cur)
                out.extend(segs)
            pieces = out

        if self.byte_level:
            out = []
            for i, piece in enumerate(pieces):
                if i == 0 and self._bl_prefix_space \
                        and not piece.startswith(" "):
                    piece = " " + piece
                out.append("".join(self._b2u[b]
                                   for b in piece.encode("utf-8")))
            pieces = out

        if self._digits_individual:
            out = []
            for piece in pieces:
                cur = ""
                for ch in piece:
                    if ch.isdigit():
                        if cur:
                            out.append(cur)
                            cur = ""
                        out.append(ch)
                    else:
                        cur += ch
                if cur:
                    out.append(cur)
            pieces = out
        return [p for p in pieces if p]

    # -- BPE ------------------------------------------------------------

    def _bpe(self, word: str) -> List[str]:
        if self.ignore_merges and word in self.vocab:
            return [word]
        return bpe_merge(word, self.ranks)

    # -- Unigram Viterbi --------------------------------------------------

    def _unigram(self, word: str) -> List[Tuple[str, bool]]:
        """Best segmentation by summed log-prob; returns (piece, known).
        Unknown chars score min_score - 10 (HF's unk penalty)."""
        n = len(word)
        unk_score = self._min_score - 10.0
        best = [(-1e30, -1, False)] * (n + 1)   # (score, backptr, known)
        best[0] = (0.0, -1, True)
        for i in range(n):
            si = best[i][0]
            if si <= -1e29:
                continue
            lim = min(n, i + self._max_tok_len)
            for j in range(i + 1, lim + 1):
                piece = word[i:j]
                sc = self.scores.get(piece)
                if sc is not None:
                    cand = si + sc
                    if cand > best[j][0]:
                        best[j] = (cand, i, True)
            # unk single char
            cand = si + unk_score
            if cand > best[i + 1][0]:
                best[i + 1] = (cand, i, False)
        pieces: List[Tuple[str, bool]] = []
        j = n
        while j > 0:
            _, i, known = best[j]
            pieces.append((word[i:j], known))
            j = i
        return pieces[::-1]

    # -- encode/decode ----------------------------------------------------

    def _encode_piece(self, piece: str, ids: List[int]) -> None:
        if self.kind == "BPE":
            segs = [(s, s in self.vocab) for s in self._bpe(piece)]
        else:
            segs = self._unigram(piece)
        pending_unk = False
        for seg, known in segs:
            tid = self.vocab.get(seg) if known else None
            if tid is not None:
                if pending_unk:
                    ids.append(self.unk_id)
                    pending_unk = False
                ids.append(tid)
                continue
            # unknown segment: byte fallback, else unk (fused / dropped)
            if self.byte_fallback:
                btoks = [self.vocab.get(f"<0x{b:02X}>")
                         for b in seg.encode("utf-8")]
                if None not in btoks:
                    if pending_unk:
                        ids.append(self.unk_id)
                        pending_unk = False
                    ids.extend(btoks)
                    continue
            if self.unk_id is None:
                continue                  # no unk token: drop (HF BPE)
            if self.fuse_unk:
                pending_unk = True
            else:
                ids.append(self.unk_id)
        if pending_unk:
            ids.append(self.unk_id)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        if not text:
            return ids
        # split out added tokens first (longest-first, verbatim ids)
        chunks: List[Tuple[str, Optional[int]]] = [(text, None)]
        for tok in self._added_sorted:
            nxt: List[Tuple[str, Optional[int]]] = []
            for chunk, tid in chunks:
                if tid is not None:
                    nxt.append((chunk, tid))
                    continue
                parts = chunk.split(tok)
                for i, part in enumerate(parts):
                    if part:
                        nxt.append((part, None))
                    if i < len(parts) - 1:
                        nxt.append((tok, self.added[tok]))
            chunks = nxt
        first = True
        for chunk, tid in chunks:
            if tid is not None:
                ids.append(tid)
                continue
            ms = self._metaspace
            if not first and ms is not None \
                    and ms.get("prepend_scheme") == "first":
                # only the first text chunk gets the prepended space
                ms = {**ms, "prepend_scheme": "never"}
            for piece in self._pretokenize(chunk, metaspace=ms):
                self._encode_piece(piece, ids)
            first = False
        return ids

    def decode(self, tokens: Sequence[int],
               skip_special: bool = True) -> str:
        rep = (self._metaspace or {}).get("replacement", "▁")
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8",
                                                  errors="replace"))
                byte_buf.clear()

        for t in tokens:
            if t == self.pad_id or not (0 <= t < self.vocab_size):
                continue
            if skip_special and (t in self.special_ids
                                 or t in (self.bos_id, self.eos_id)):
                continue
            piece = self.tokens[t]
            if (self.byte_fallback and len(piece) == 6
                    and piece.startswith("<0x") and piece.endswith(">")):
                try:
                    byte_buf.append(int(piece[3:5], 16))
                    continue
                except ValueError:
                    pass
            if self.byte_level and t not in self.added.values():
                # accumulate: one UTF-8 char may span several tokens
                byte_buf.extend(self._u2b.get(ch, ord("?"))
                                for ch in piece)
            else:
                flush()
                out.append(piece.replace(rep, " "))
        flush()
        text = "".join(out)
        if (self._metaspace or self._prepend) and text.startswith(" "):
            text = text[1:]
        return text


def _regex():
    """The `regex` module, which Split and ByteLevel patterns need (HF
    patterns use \\p{L} classes that `re` lacks)."""
    try:
        import regex
    except ImportError as e:
        raise ImportError(
            "this tokenizer.json has a Split or ByteLevel pre-tokenizer, "
            "which needs the `regex` module") from e
    return regex


def _compile(pattern: str):
    return _regex().compile(pattern)


def _escape(s: str) -> str:
    return _regex().escape(s)


# ---------------------------------------------------------------------------
# Directory / file entry points
# ---------------------------------------------------------------------------

def from_tokenizer_json(path: str,
                        hf_config: Optional[Dict[str, Any]] = None,
                        tokenizer_config: Optional[Dict[str, Any]] = None
                        ) -> HFTokenizer:
    """Load tokenizer.json; bos/eos resolved from tokenizer_config.json
    token strings or config.json ids when provided."""
    with open(path, encoding="utf-8") as f:
        tj = json.load(f)
    bos = eos = None
    if tokenizer_config:
        def _tok_str(v):
            return v.get("content") if isinstance(v, dict) else v
        lookup: Dict[str, int] = {}
        if "vocab" in tj["model"] and tj["model"]["type"] == "BPE":
            lookup.update(tj["model"]["vocab"])
        else:
            lookup.update({t: i for i, (t, _) in
                           enumerate(tj["model"].get("vocab", []))})
        for t in tj.get("added_tokens", []) or []:
            lookup[t["content"]] = int(t["id"])
        b = _tok_str(tokenizer_config.get("bos_token"))
        e = _tok_str(tokenizer_config.get("eos_token"))
        bos = lookup.get(b) if b else None
        eos = lookup.get(e) if e else None
    if hf_config:
        if bos is None and hf_config.get("bos_token_id") is not None:
            bos = int(hf_config["bos_token_id"])
        if eos is None and hf_config.get("eos_token_id") is not None:
            eid = hf_config["eos_token_id"]
            eos = int(eid[0] if isinstance(eid, (list, tuple)) else eid)
    tok = HFTokenizer(tj, bos_id=bos, eos_id=eos)
    from turboinfer_tpu_torch.tokenizer import chat as chat_mod
    tok.chat_template = chat_mod.from_tokenizer_config(
        tokenizer_config,
        bos_token=(tok.tokens[tok.bos_id]
                   if 0 <= tok.bos_id < tok.vocab_size else ""),
        eos_token=(tok.tokens[tok.eos_id]
                   if 0 <= tok.eos_id < tok.vocab_size else ""))
    return tok


def from_hf_dir(dirname: str) -> Optional[HFTokenizer]:
    """Build a tokenizer from an HF checkpoint directory's sidecars, or
    None if there is no tokenizer.json."""
    import os
    tjp = os.path.join(dirname, "tokenizer.json")
    if not os.path.exists(tjp):
        return None

    def _maybe(name):
        p = os.path.join(dirname, name)
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                return json.load(f)
        return None

    return from_tokenizer_json(tjp, hf_config=_maybe("config.json"),
                               tokenizer_config=_maybe(
                                   "tokenizer_config.json"))
