"""Tokenizers: SPM-BPE (llama), byte-level BPE (gpt2), builtin toy; the
counterparts of turboinfer_tpu/tokenizer/bpe.py."""

from turboinfer_tpu_torch.tokenizer.bpe import (BPETokenizer,
                                                BuiltinTokenizer,
                                                SPMTokenizer, Tokenizer,
                                                from_gguf_metadata)

__all__ = ["BPETokenizer", "BuiltinTokenizer", "SPMTokenizer", "Tokenizer",
           "from_gguf_metadata"]
