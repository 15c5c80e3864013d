"""Model loading, the counterpart of turboinfer_tpu/loader: GGUF v3,
SafeTensors (single and sharded), PyTorch state dicts, TINQ and HF
checkpoint directories into the port's parameters on the device; PEFT
LoRA adapters; checkpoint directories; seeded synthetic models."""

from turboinfer_tpu_torch.loader.ckpt import load_checkpoint, save_checkpoint
from turboinfer_tpu_torch.loader.loader import (ModelData, detect_format,
                                                load_checkpoint_dir,
                                                load_engine, load_gguf,
                                                load_model_data, load_pytorch,
                                                load_safetensors,
                                                load_safetensors_sharded,
                                                load_tinq)
from turboinfer_tpu_torch.loader.lora import (apply_lora, load_lora,
                                              merge_lora, strip_lora)
from turboinfer_tpu_torch.loader.synthetic import (
    create_synthetic_model, create_synthetic_quantized_model)

__all__ = ["ModelData", "detect_format", "load_checkpoint_dir",
           "load_engine", "load_gguf", "load_model_data", "load_pytorch",
           "load_safetensors", "load_safetensors_sharded", "load_tinq",
           "create_synthetic_model", "create_synthetic_quantized_model",
           "save_checkpoint",
           "load_checkpoint", "load_lora", "apply_lora", "merge_lora",
           "strip_lora"]
