"""Constrained (structured) decoding: grammar-masked token selection;
the counterpart of turboinfer_tpu/structured/. Masks stay numpy on the
host; only a slot's bias row goes to the device."""

from turboinfer_tpu_torch.structured.filter import JsonTokenFilter, \
    TokenMaskCache, token_bytes_table
from turboinfer_tpu_torch.structured import json_fsm

__all__ = ["JsonTokenFilter", "TokenMaskCache", "token_bytes_table",
           "json_fsm"]
