"""Serving layer: ServingEngine (a serving thread that owns the scheduler
and every device call) and an OpenAI-compatible HTTP server
(counterpart of turboinfer_tpu/serve)."""

from turboinfer_tpu_torch.serve.engine import ServingEngine, StreamEnd
from turboinfer_tpu_torch.serve.http_server import make_server, serve_forever

__all__ = ["ServingEngine", "StreamEnd", "make_server", "serve_forever"]
