"""Device-time measurement from torch.profiler's records.

Port of ``plslam_tpu/utils/devtime.py``: ``device_time_ms`` and
``kernel_breakdown_ms`` keep the reference's signatures and read the
profiler's device records instead of a JAX trace. PyTorch returns before
the device has finished, so a host clock without a synchronise measures
the enqueue; the device's own records (or CUDA events, ``cuda_ms``) are
the honest measurement. They profile the card wherever
``torch.cuda.is_available()``, whatever ``fn`` takes (a closure with no
arguments is the usual call); without a card, or asked with ``cpu=True``,
they read the CPU ops' own time instead, so they run on the CPU.

``profile_device`` is the shared core: it takes a profile again where the
profiler came back without device records (on the H100 about once in 70
profiles, at times six in a row late in a long run).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, List, Tuple

import torch


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after warm-up,
    from CUDA events (host work included where the host is the slower
    side)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_table(prof, cuda: bool = True) -> dict:
    """{name: (records, us)} of a profile's device records (``cuda``) or,
    for a CPU run, of its CPU ops' own (self) time."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        on_device = e.device_type != DeviceType.CPU
        if cuda and on_device and e.count > 0:
            n, us = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, us + e.device_time_total)
        elif not cuda and not on_device and e.count > 0:
            n, us = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, us + e.self_cpu_time_total)
    return out


def _profile(fn, iters: int, cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
    return prof


def profile_device(fn, keep: Callable[[str], bool], iters: int,
                   cuda: bool = True) -> Tuple[float, int]:
    """(device ms, device kernels) a call of ``fn`` spends in the device
    records whose name ``keep`` accepts, from torch.profiler over
    ``iters`` calls after a warm-up (``cuda`` False: the CPU ops' own time
    and count). torch.profiler may lose some of a kernel's records (on the
    H100 often: 6 to 9 of 10 one-launch calls recorded): each kernel
    counts its mean record's time as many times a call as its records a
    call round up to, exact while it loses fewer than ``iters`` of them.
    Raises where 12 profiles gave no device records."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    for attempt in range(12):
        table = device_table(_profile(fn, iters, cuda), cuda)
        ev = [(n, us) for k, (n, us) in table.items() if keep(k)]
        if sum(us for _, us in ev) > 0:
            if attempt:
                print(f"[profile] device records came on try {attempt + 1}",
                      flush=True)
            per = [math.ceil(n / iters) for n, _ in ev]
            ms = sum(us / n * p for (n, us), p in zip(ev, per)) / 1e3
            return ms, sum(per)
    raise RuntimeError("torch.profiler gave no device records in 12 "
                       "tries: device time not measured")


def all_kernels(fn, iters: int = 10) -> Tuple[float, int]:
    """(device ms, device kernels) a call of ``fn`` over every kernel and
    copy on the device, torch's included."""
    return profile_device(fn, lambda k: True, iters)


def _use_cuda(cpu: bool) -> bool:
    return not cpu and torch.cuda.is_available()


def device_time_ms(fn, *args, iters: int = 5, warmup: int = 1,
                   cpu: bool = False) -> float:
    """Mean device time (ms) of one call ``fn(*args)``: every device
    record's time, over ``iters`` calls after ``warmup``; raises where the
    profiler gives no device records. Without a card, or with ``cpu``,
    the CPU ops' own time."""
    cuda = _use_cuda(cpu)
    for _ in range(max(warmup - 1, 0)):
        fn(*args)
    return profile_device(lambda: fn(*args), lambda k: True, iters,
                          cuda)[0]


def kernel_breakdown_ms(fn, *args, iters: int = 3, top: int = 15,
                        cpu: bool = False) -> List[Tuple[str, float]]:
    """The ``top`` device kernels of ``fn(*args)``: (name, its first 70
    characters; ms a call), the most time first (CPU ops without a card
    or with ``cpu``)."""
    cuda = _use_cuda(cpu)
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    durs: Counter = Counter()
    for k, (_, us) in device_table(_profile(lambda: fn(*args), iters,
                                            cuda), cuda).items():
        durs[k[:70]] += us
    return [(n, us / 1e3 / iters) for n, us in durs.most_common(top)]
