"""Tokenizers: SentencePiece-BPE (llama-family GGUF), byte-level BPE
(gpt2-family GGUF), and the built-in toy tokenizer; the counterparts of
turboinfer_tpu/tokenizer/bpe.py, token for token. The SPM encoder runs
in the native library (turboinfer_tpu_torch/native.py) when it is
built, else in the Python merge loop below; both give the same ids.
Chat templates render through tokenizer/chat.py; a GGUF's
`tokenizer.chat_template` is attached at load.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple


class Tokenizer:
    """Common interface."""

    vocab_size: int
    bos_id: int
    eos_id: int
    unk_id: int
    pad_id: int
    chat_template = None      # Optional[chat.ChatTemplate], set by loaders

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        raise NotImplementedError

    def decode(self, tokens: Sequence[int]) -> str:
        raise NotImplementedError

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            tokenize=False, add_bos=True, **extra):
        """Render a [{"role","content"}...] conversation to the model's
        prompt (string, or token ids with tokenize=True). Uses the
        checkpoint's own template; ChatML when it ships none."""
        from turboinfer_tpu_torch.tokenizer import chat as chat_mod
        tpl = self.chat_template or chat_mod.ChatTemplate()
        text = tpl.render(messages,
                          add_generation_prompt=add_generation_prompt,
                          **extra)
        if not tokenize:
            return text
        # templates that bake the BOS into the text shouldn't get two
        if add_bos and tpl.bos_token and text.startswith(tpl.bos_token):
            add_bos = False
        return self.encode(text, add_bos=add_bos)


# ---------------------------------------------------------------------------
# SentencePiece-style BPE (llama-family GGUF: tokens + scores + byte fallback)
# ---------------------------------------------------------------------------

class SPMTokenizer(Tokenizer):
    """Score-driven BPE over '▁'-marked text with byte fallback.

    Built from GGUF metadata arrays: tokenizer.ggml.tokens (strings),
    tokenizer.ggml.scores (floats), tokenizer.ggml.token_type (ints).
    """

    SPACE = "▁"  # ▁

    def __init__(self, tokens: Sequence[str], scores: Sequence[float],
                 token_types: Optional[Sequence[int]] = None,
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 pad_id: int = -1, add_space_prefix: bool = True):
        self.tokens = list(tokens)
        self.scores = list(scores) if scores else [0.0] * len(self.tokens)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.vocab_size = len(self.tokens)
        self.bos_id, self.eos_id = bos_id, eos_id
        self.unk_id, self.pad_id = unk_id, pad_id
        self.add_space_prefix = add_space_prefix
        # byte fallback tokens look like "<0x0A>"
        self._byte_ids: Dict[int, int] = {}
        for b in range(256):
            tid = self.vocab.get(f"<0x{b:02X}>")
            if tid is not None:
                self._byte_ids[b] = tid
        self._native = None
        self._native_tried = False

    def _native_encoder(self):
        """Lazy native turboio encoder (O(n log n) agenda merge); falls
        back to the Python scan loop when the library is unavailable."""
        if not self._native_tried:
            self._native_tried = True
            try:
                from turboinfer_tpu_torch import native as tio
                self._native = tio.NativeSPMEncoder(
                    self.tokens, self.scores, self.add_space_prefix)
            except (ImportError, OSError):
                self._native = None
        return self._native

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        if not text:
            return [self.bos_id] if add_bos else []
        enc = self._native_encoder()
        if enc is not None:
            return enc.encode(text, add_bos=add_bos, bos_id=self.bos_id,
                              unk_id=self.unk_id)
        s = text.replace(" ", self.SPACE)
        if self.add_space_prefix and not s.startswith(self.SPACE):
            s = self.SPACE + s

        # Start from single characters; byte-fallback for unknown chars.
        pieces: List[str] = list(s)
        # Agenda-based greedy merge: repeatedly merge the adjacent pair
        # whose concatenation is an in-vocab piece with the best score.
        while True:
            best_i, best_score = -1, -1e30
            for i in range(len(pieces) - 1):
                cand = pieces[i] + pieces[i + 1]
                tid = self.vocab.get(cand)
                if tid is not None and self.scores[tid] > best_score:
                    best_i, best_score = i, self.scores[tid]
            if best_i < 0:
                break
            pieces[best_i: best_i + 2] = [pieces[best_i] + pieces[best_i + 1]]

        ids: List[int] = [self.bos_id] if add_bos else []
        for p in pieces:
            tid = self.vocab.get(p)
            if tid is not None:
                ids.append(tid)
            else:
                for b in p.encode("utf-8"):
                    ids.append(self._byte_ids.get(b, self.unk_id))
        return ids

    def decode(self, tokens: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for t in tokens:
            if t in (self.bos_id, self.eos_id, self.pad_id):
                continue
            if not (0 <= t < self.vocab_size):
                continue
            piece = self.tokens[t]
            if (len(piece) == 6 and piece.startswith("<0x")
                    and piece.endswith(">")):
                try:
                    byte_buf.append(int(piece[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(piece.replace(self.SPACE, " "))
        flush()
        text = "".join(out)
        return text[1:] if text.startswith(" ") else text


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE (tokens + merges)
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 printable byte↔unicode bijection."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def bpe_merge(word: str, ranks: Dict[Tuple[str, str], int]) -> List[str]:
    """Greedy lowest-rank merge loop shared by the GGUF and HF BPE
    paths (identical semantics; one implementation to fix)."""
    parts = list(word)
    while len(parts) > 1:
        best, best_rank = None, None
        for i in range(len(parts) - 1):
            r = ranks.get((parts[i], parts[i + 1]))
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best is None:
            break
        parts[best: best + 2] = [parts[best] + parts[best + 1]]
    return parts


class BPETokenizer(Tokenizer):
    """Merge-rank byte-level BPE (gpt2-family GGUF / HF vocab+merges)."""

    byte_level = True   # pieces live in the b2u alphabet (constrained
                        # decoding maps them back through _u2b)

    def __init__(self, tokens: Sequence[str], merges: Sequence[str],
                 bos_id: int = 0, eos_id: int = 0, unk_id: int = 0,
                 pad_id: int = -1):
        self.tokens = list(tokens)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.vocab_size = len(self.tokens)
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r
        self.bos_id, self.eos_id = bos_id, eos_id
        self.unk_id, self.pad_id = unk_id, pad_id
        self._b2u = _bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}

    def _bpe(self, word: str) -> List[str]:
        return bpe_merge(word, self.ranks)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        if not text:
            return ids
        # Simple pretokenization: split on spaces keeping them attached to
        # the following word (Ġ convention).
        u = "".join(self._b2u[b] for b in text.encode("utf-8"))
        words: List[str] = []
        cur = ""
        for ch in u:
            if ch == self._b2u[ord(" ")] and cur:
                words.append(cur)
                cur = ch
            else:
                cur += ch
        if cur:
            words.append(cur)
        for w in words:
            for piece in self._bpe(w):
                ids.append(self.vocab.get(piece, self.unk_id))
        return ids

    def decode(self, tokens: Sequence[int]) -> str:
        chars = []
        for t in tokens:
            if t in (self.pad_id,):
                continue
            if 0 <= t < self.vocab_size:
                chars.append(self.tokens[t])
        u = "".join(chars)
        data = bytes(self._u2b.get(ch, ord("?")) for ch in u)
        return data.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Built-in toy tokenizer (engines with no vocab file)
# ---------------------------------------------------------------------------

# Our own compact English subword list (reference ships ~120 hardcoded
# common subwords, inference_engine.cpp:1246-1283; this is an equivalent,
# independently chosen set).
_COMMON = [
    "the", "and", "ing", "ion", "to", "of", "in", "is", "it", "that",
    "for", "was", "on", "are", "with", "as", "his", "they", "be", "at",
    "one", "have", "this", "from", "or", "had", "by", "word", "but",
    "what", "some", "we", "can", "out", "other", "were", "all", "there",
    "when", "up", "use", "your", "how", "said", "an", "each", "she",
    "which", "do", "their", "time", "if", "will", "way", "about", "many",
    "then", "them", "write", "would", "like", "so", "these", "her",
    "long", "make", "thing", "see", "him", "two", "has", "look", "more",
    "day", "could", "go", "come", "did", "number", "sound", "no", "most",
    "people", "my", "over", "know", "water", "than", "call", "first",
    "who", "may", "down", "side", "been", "now", "find", "any", "new",
    "work", "part", "take", "get", "place", "made", "live", "where",
    "after", "back", "little", "only", "round", "man", "year", "came",
    "show", "every", "good", "me", "give", "our", "under", "name",
]


class BuiltinTokenizer(Tokenizer):
    """Byte-level tokenizer with a small English subword vocab.

    Reference parity: the toy built-in tokenizer
    (inference_engine.cpp:1224-1297) — 4 specials, 256 byte tokens,
    common subwords; greedy longest-match encoding. vocab ids:
      0 <pad>, 1 <s>, 2 </s>, 3 <unk>, 4..259 bytes, 260.. subwords.
    """

    def __init__(self, vocab_size: Optional[int] = None):
        self.specials = ["<pad>", "<s>", "</s>", "<unk>"]
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.tokens = list(self.specials)
        self.tokens += [f"<0x{b:02X}>" for b in range(256)]
        self.tokens += _COMMON
        if vocab_size is not None and vocab_size > len(self.tokens):
            self.tokens += [f"<extra_{i}>"
                            for i in range(vocab_size - len(self.tokens))]
        self.vocab_size = vocab_size or len(self.tokens)
        self._sub: Dict[str, int] = {
            w: 260 + i for i, w in enumerate(_COMMON)
            if 260 + i < self.vocab_size}
        self._max_sub = max((len(w) for w in self._sub), default=0)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        low = text.lower()
        while i < len(text):
            matched = False
            for ln in range(min(self._max_sub, len(text) - i), 1, -1):
                tid = self._sub.get(low[i:i + ln])
                if tid is not None:
                    ids.append(tid)
                    i += ln
                    matched = True
                    break
            if not matched:
                for b in text[i].encode("utf-8"):
                    ids.append(4 + b)
                i += 1
        return ids

    def decode(self, tokens: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for t in tokens:
            if t in (self.pad_id, self.bos_id, self.eos_id):
                continue
            if 4 <= t < 260:
                byte_buf.append(t - 4)
            elif t in range(260, 260 + len(_COMMON)):
                flush()
                out.append(_COMMON[t - 260])
            else:
                flush()
        flush()
        return "".join(out)


# ---------------------------------------------------------------------------
# Factory from GGUF metadata
# ---------------------------------------------------------------------------

def from_gguf_metadata(md: Dict[str, Any]) -> Optional[Tokenizer]:
    """Build the right tokenizer from parsed GGUF metadata, or None if
    the file carries no vocab."""
    tokens = md.get("tokenizer.ggml.tokens")
    if not tokens:
        return None
    model = str(md.get("tokenizer.ggml.model", "llama"))
    bos = int(md.get("tokenizer.ggml.bos_token_id", 1))
    eos = int(md.get("tokenizer.ggml.eos_token_id", 2))
    unk = int(md.get("tokenizer.ggml.unknown_token_id", 0))
    pad = int(md.get("tokenizer.ggml.padding_token_id", -1))
    if model in ("gpt2", "bpe"):
        merges = md.get("tokenizer.ggml.merges", [])
        tok = BPETokenizer(tokens, merges, bos_id=bos, eos_id=eos,
                           unk_id=unk, pad_id=pad)
    else:
        scores = md.get("tokenizer.ggml.scores", [])
        types = md.get("tokenizer.ggml.token_type")
        prefix = bool(md.get("tokenizer.ggml.add_space_prefix", True))
        tok = SPMTokenizer(tokens, scores, types, bos_id=bos, eos_id=eos,
                           unk_id=unk, pad_id=pad, add_space_prefix=prefix)
    if md.get("tokenizer.chat_template"):
        from turboinfer_tpu_torch.tokenizer import chat as chat_mod
        tok.chat_template = chat_mod.from_gguf_metadata(md, list(tokens))
    return tok
