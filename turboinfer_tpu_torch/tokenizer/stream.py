"""Incremental detokenization for streaming; the counterpart of
turboinfer_tpu/tokenizer/stream.py.

Re-decoding the whole token list per emitted token is O(n^2) in stream
length. This decoder is O(1) per token: each token contributes a fixed
byte string (structured.filter.token_bytes_table: exact concatenation
semantics for byte-level, Metaspace/SPM and byte-fallback vocabs), and
UTF-8 is decoded incrementally with the incomplete tail withheld until
its continuation bytes arrive.

Falls back to a full re-decode only when a tokenizer exposes no
.tokens table.
"""

from __future__ import annotations

import codecs
from typing import List, Optional


class IncrementalDecoder:
    """Feed token ids, get text deltas; never splits a UTF-8 char."""

    def __init__(self, tokenizer, skip_special: bool = True):
        self.tok = tokenizer
        self.ids: List[int] = []
        self._table = None
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")
        self._emitted = ""          # fallback path bookkeeping
        self._started = False       # saw the first non-empty delta
        self._lead_space = None     # metaspace/prepend strip (first delta)
        if tokenizer is not None and getattr(tokenizer, "tokens", None):
            try:
                from turboinfer_tpu_torch.structured.filter import \
                    token_bytes_table
                self._table = token_bytes_table(tokenizer)
                self._lead_space = bool(
                    getattr(tokenizer, "_metaspace", None)
                    or getattr(tokenizer, "_prepend", None)
                    or getattr(tokenizer, "SPACE", None))
            except Exception:       # exotic tokenizer: full-redecode path
                self._table = None

    def push(self, token: int) -> str:
        """One token id → newly stable text ("" while a multi-token
        UTF-8 sequence is still incomplete)."""
        self.ids.append(int(token))
        if self.tok is None:
            return ""
        if self._table is not None:
            bs = (self._table[token]
                  if 0 <= token < len(self._table) else None)
            if bs is None:              # special token: no text
                return ""
            out = self._dec.decode(bs)
            if out and not self._started:
                if self._lead_space and out.startswith(" "):
                    out = out[1:]       # match decode()'s leading strip
                self._started = True
            return out
        # fallback: full re-decode with trailing-U+FFFD withholding
        full = self.tok.decode(self.ids)
        while full.endswith("�"):
            full = full[:-1]
        delta = full[len(self._emitted):]
        self._emitted = full
        return delta

    def flush(self) -> str:
        """Emit anything still buffered (end of stream)."""
        if self._table is not None:
            return self._dec.decode(b"", final=True)
        return ""
