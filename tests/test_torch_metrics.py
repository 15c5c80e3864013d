"""EngineStats of the port (utils/metrics.py) against turboinfer_tpu's:
the efficiency tiers and the report's lines on the same counters."""

import pytest

from turboinfer_tpu.utils.metrics import EngineStats as JStats
from turboinfer_tpu_torch.utils.metrics import EngineStats as TStats


def _pair(tokens, seconds):
    out = []
    for cls in (JStats, TStats):
        s = cls(created_at=0.0)
        s.record_generation(new_tokens=tokens, elapsed_s=seconds,
                            prefill_s=0.25 * seconds, batch=2)
        out.append(s)
    return out


@pytest.mark.parametrize("tps,tier", [
    (2000.0, "Excellent"), (1000.5, "Excellent"), (1000.0, "Good"),
    (500.5, "Good"), (500.0, "Fair"), (100.5, "Fair"), (100.0, "Poor"),
    (3.0, "Poor")])
def test_efficiency_rating_tiers_match_jax(tps, tier):
    """Above 1000 tok/s Excellent, above 500 Good, above 100 Fair, else
    Poor: the boundaries themselves fall to the lower tier, as JAX's."""
    j, t = _pair(int(tps * 2), 2.0)
    assert t.average_tokens_per_second == j.average_tokens_per_second == tps
    assert t.efficiency_rating() == j.efficiency_rating() == tier


def test_report_lines_match_jax_with_the_device_line():
    """The report is JAX's line for line (its header named for the port)
    plus the port's "Device:" line after the model."""
    j, t = _pair(3000, 2.5)
    jl = j.report(model_name="m", memory_bytes=3 << 20).splitlines()
    tl = t.report(model_name="m", memory_bytes=3 << 20,
                  device="cpu").splitlines()
    assert tl[2] == "Device:               cpu"
    assert tl[:2] + tl[3:] == [tl[0]] + jl[1:]
    assert tl[-1] == "Efficiency rating:    Excellent" == jl[-1]
