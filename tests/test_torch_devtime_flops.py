"""Port parity: utils/flops.py and utils/devtime.py.

The five counting functions give the reference's floats, bit for bit, on
the default ``SlamConfig()``, a points-only and a lines-only variant;
``device_time_ms`` and ``kernel_breakdown_ms`` run on a CPU call (its CPU
ops' own time, asked with ``cpu=True``) with the reference's signatures,
and profile the card wherever one is present, a closure with no
arguments (the reference's callers' form) included.
"""

import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.utils import flops as jflops
from plslam_tpu_torch import convert
from plslam_tpu_torch.utils import devtime, flops

VARIANTS = {"default": {}, "points_only": {"lines": {"has_lines": False}},
            "lines_only": {"points": {"has_points": False}}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flops_equal_reference(variant):
    jc = SlamConfig().with_updates(VARIANTS[variant])
    tc = convert.config_from_dict(jc.to_dict())
    for name, args in (("extract_flops", (40,)), ("tracking_flops", (20,)),
                       ("backend_flops", (3, 1, 3)),
                       ("vo_chunk_total", (20,)),
                       ("slam_chunk_total", (20, 2.5))):
        got = getattr(flops, name)(tc, *args)
        ref = getattr(jflops, name)(jc, *args)
        assert got == ref, (name, got, ref)
    assert not hasattr(flops, "PEAK_FLOPS_BF16")
    assert (flops.HBM_BYTES_PER_S, flops.F32_OPS_PER_S,
            flops.INT8_OPS_PER_S) == (3.35e12, 67e12, 1979e12)


def test_devtime_on_a_cpu_call():
    torch.set_num_threads(1)
    a = torch.rand(64, 64)
    b = torch.rand(64, 64)
    f = lambda x, y: torch.relu(x @ y) + x
    ms = devtime.device_time_ms(f, a, b, iters=3, warmup=1, cpu=True)
    assert 0.0 < ms < 1e3
    top = devtime.kernel_breakdown_ms(f, a, b, iters=2, top=3, cpu=True)
    assert 1 <= len(top) <= 3
    names = [n for n, _ in top]
    assert all(isinstance(n, str) and len(n) <= 70 for n in names)
    assert any("mm" in n for n in names)
    assert all(t >= 0.0 for _, t in top)
    assert top == sorted(top, key=lambda nt: -nt[1])
    if not torch.cuda.is_available():     # no card: the CPU by default
        assert devtime.device_time_ms(lambda: f(a, b), iters=2) > 0.0


def test_devtime_closure_takes_the_device_branch(monkeypatch):
    """With a card present, a closure with no arguments is profiled on
    the card (CUDA activity, device records), not on the CPU."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(devtime, "profile_device",
                        lambda fn, keep, iters, cuda=True:
                        seen.append(("time", cuda)) or (1.0, 1))

    class _Prof:
        def key_averages(self):
            return []

    monkeypatch.setattr(devtime, "_profile",
                        lambda fn, iters, cuda: seen.append(("top", cuda))
                        or _Prof())
    calls = []
    closure = lambda: calls.append(1)
    assert devtime.device_time_ms(closure) == 1.0
    assert devtime.kernel_breakdown_ms(closure) == []
    assert seen == [("time", True), ("top", True)]
    devtime.device_time_ms(closure, cpu=True)
    devtime.kernel_breakdown_ms(closure, cpu=True)
    assert seen[2:] == [("time", False), ("top", False)]
