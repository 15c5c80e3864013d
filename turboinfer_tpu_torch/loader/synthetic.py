"""Random-weight quantized LLaMA-class model built directly in the packed
format on the device (counterpart of turboinfer_tpu/loader/synthetic.py
create_synthetic_quantized_model): a 7B fixture never exists in fp.
Values are random (uniform bytes, scales 0.01); use it to measure speed,
not accuracy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ModelData:
    params: Dict[str, Any]
    config: ModelConfig
    source_format: str = "synthetic-quantized"


def create_synthetic_quantized_model(config: ModelConfig, bits: int = 4,
                                     group_size: int = 64, device="cuda",
                                     seed: int = 0) -> ModelData:
    dev = resolve_device(device)
    c = config
    if c.num_experts or c.kv_lora_rank:
        raise NotImplementedError("MoE / MLA fixtures are not ported yet")
    L, H, V, F = c.num_layers, c.hidden_size, c.vocab_size, c.ffn_dim
    QD, KVD, G = c.q_dim, c.kv_dim, group_size
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rq(K, N, lead=(L,)):
        if bits == 4:
            data = torch.randint(0, 255, lead + (K // 2, N), generator=gen,
                                 dtype=torch.uint8, device=dev)
        else:
            data = torch.randint(-127, 127, lead + (K, N), generator=gen,
                                 dtype=torch.int8, device=dev)
        scales = torch.full(lead + (K // G, N), 0.01, dtype=torch.bfloat16,
                            device=dev)
        return QTensor(data=data, scales=scales, zero_points=None,
                       bits=bits, group_size=G, shape=(K, N))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    params = {
        "embed": (torch.randn((V, H), generator=gen, device=dev) * 0.02
                  ).to(torch.bfloat16),
        "layers": {
            "attn_norm": ones(L, H), "ffn_norm": ones(L, H),
            "wq": rq(H, QD), "wk": rq(H, KVD), "wv": rq(H, KVD),
            "wo": rq(QD, H),
            "w_gate": rq(H, F), "w_up": rq(H, F), "w_down": rq(F, H),
        },
        "final_norm": ones(H),
        "lm_head": rq(H, V, lead=()),
    }
    return ModelData(params=params, config=config)
