"""Tokenizers: SPM-BPE (llama), byte-level BPE (gpt2), builtin toy, HF
tokenizer.json, chat templates and streaming detokenization; the
counterparts of turboinfer_tpu/tokenizer/."""

from turboinfer_tpu_torch.tokenizer.bpe import (BPETokenizer,
                                                BuiltinTokenizer,
                                                SPMTokenizer, Tokenizer,
                                                from_gguf_metadata)

__all__ = ["BPETokenizer", "BuiltinTokenizer", "SPMTokenizer", "Tokenizer",
           "from_gguf_metadata"]
