"""Chat template rendering (HF `chat_template` Jinja format); the
counterpart of turboinfer_tpu/tokenizer/chat.py, render for render.

Turns a message list [{"role": ..., "content": ...}, ...] into the
model's prompt string with the checkpoint's own template, from
tokenizer_config.json (HF sidecar) or the `tokenizer.chat_template`
GGUF metadata key. Rendering follows `transformers.apply_chat_template`:
a sandboxed Jinja environment with trim_blocks/lstrip_blocks and the
`raise_exception` / `tojson` / `strftime_now` helpers. Falls back to
ChatML when a checkpoint ships no template. jinja2 is imported when a
template is compiled; without it that raises ImportError.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

# ChatML — the de-facto default for template-less checkpoints (what HF
# used as its legacy default_chat_template).
DEFAULT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] "
    "+ '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|im_start|>assistant\n' }}"
    "{% endif %}")


def _environment():
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise ValueError(f"chat template error: {message}")

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        import datetime
        return datetime.datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(trim_blocks=True,
                                        lstrip_blocks=True,
                                        extensions=["jinja2.ext.loopcontrols"])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env


class ChatTemplate:
    """A compiled chat template."""

    def __init__(self, source: Optional[str] = None,
                 bos_token: str = "", eos_token: str = ""):
        self.source = source or DEFAULT_TEMPLATE
        self.is_default = source is None
        self.bos_token = bos_token
        self.eos_token = eos_token
        self._compiled = _environment().from_string(self.source)

    def render(self, messages: Sequence[Dict[str, Any]],
               add_generation_prompt: bool = True,
               **extra: Any) -> str:
        """Messages [{"role","content"}...] → prompt string. `extra`
        exposes additional template variables (tools, documents, ...)."""
        return self._compiled.render(
            messages=list(messages),
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token, eos_token=self.eos_token, **extra)


def from_tokenizer_config(tc: Optional[Dict[str, Any]],
                          bos_token: str = "",
                          eos_token: str = "") -> ChatTemplate:
    """tokenizer_config.json dict → ChatTemplate. Handles the plain
    string form and the named-list form ([{"name","template"}, ...] —
    the "default" entry wins)."""
    src = None
    if tc:
        ct = tc.get("chat_template")
        if isinstance(ct, str):
            src = ct
        elif isinstance(ct, list):
            for entry in ct:
                if isinstance(entry, dict) and entry.get("template"):
                    src = entry["template"]
                    if entry.get("name") == "default":
                        break

        def _tok_str(v):
            return v.get("content") if isinstance(v, dict) else (v or "")
        bos_token = _tok_str(tc.get("bos_token")) or bos_token
        eos_token = _tok_str(tc.get("eos_token")) or eos_token
    return ChatTemplate(src, bos_token=bos_token, eos_token=eos_token)


def from_gguf_metadata(md: Dict[str, Any],
                       tokens: Optional[List[str]] = None) -> ChatTemplate:
    """GGUF metadata → ChatTemplate (`tokenizer.chat_template` key);
    bos/eos token strings looked up from the vocab when available."""
    src = md.get("tokenizer.chat_template")
    bos = eos = ""
    if tokens:
        bid = md.get("tokenizer.ggml.bos_token_id")
        eid = md.get("tokenizer.ggml.eos_token_id")
        if bid is not None and 0 <= int(bid) < len(tokens):
            bos = tokens[int(bid)]
        if eid is not None and 0 <= int(eid) < len(tokens):
            eos = tokens[int(eid)]
    return ChatTemplate(src if isinstance(src, str) else None,
                        bos_token=bos, eos_token=eos)
