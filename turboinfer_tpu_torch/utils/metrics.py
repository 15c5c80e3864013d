"""Engine performance counters and the formatted report."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class EngineStats:
    total_generations: int = 0
    total_tokens: int = 0
    total_time_s: float = 0.0
    total_prefill_s: float = 0.0
    total_batch: int = 0
    peak_tokens_per_second: float = 0.0
    created_at: float = dataclasses.field(default_factory=time.time)

    def record_generation(self, new_tokens: int, elapsed_s: float,
                          prefill_s: float, batch: int = 1):
        self.total_generations += 1
        self.total_tokens += new_tokens
        self.total_time_s += elapsed_s
        self.total_prefill_s += prefill_s
        self.total_batch += batch
        tps = new_tokens / max(elapsed_s, 1e-9)
        self.peak_tokens_per_second = max(self.peak_tokens_per_second, tps)

    @property
    def average_tokens_per_second(self) -> float:
        return self.total_tokens / max(self.total_time_s, 1e-9)

    @property
    def average_ttft_ms(self) -> float:
        return 1e3 * self.total_prefill_s / max(self.total_generations, 1)

    def efficiency_rating(self) -> str:
        """The tiered score of the average throughput: above 1000 tok/s
        Excellent, above 500 Good, above 100 Fair, else Poor."""
        tps = self.average_tokens_per_second
        if tps > 1000:
            return "Excellent"
        if tps > 500:
            return "Good"
        if tps > 100:
            return "Fair"
        return "Poor"

    def report(self, model_name: str = "", memory_bytes: int = 0,
               device: str = "") -> str:
        lines = [
            "=== TurboInfer (PyTorch) Performance Stats ===",
            f"Model:                {model_name}",
            f"Device:               {device}",
            f"Generations:          {self.total_generations}",
            f"Sequences (batched):  {self.total_batch}",
            f"Tokens generated:     {self.total_tokens}",
            f"Total time:           {self.total_time_s * 1e3:.1f} ms",
            f"Avg throughput:       {self.average_tokens_per_second:.1f} tok/s",
            f"Peak throughput:      {self.peak_tokens_per_second:.1f} tok/s",
            f"Avg TTFT:             {self.average_ttft_ms:.1f} ms",
            f"Memory (weights+kv):  {memory_bytes / 2**20:.1f} MiB",
            f"Efficiency rating:    {self.efficiency_rating()}",
        ]
        return "\n".join(lines)
