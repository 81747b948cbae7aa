"""What the serving benchmarks share: the model (the published
configuration on the card, its smoke configuration on the CPU, random
weights from a seed), the name of the device a row ran on, and device
time by kernel from ``torch.profiler``."""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def model(arch: str, device, *, seed: int = 0, dtype: str | None = None,
          layers: int | None = None):
    """``(cfg, params)``: ``arch`` at its published width and depth on a
    CUDA device, its smoke configuration elsewhere, in ``dtype`` and at
    ``layers`` layers when given; weights from ``M.init_params`` on a
    generator seeded with ``seed`` on ``device``."""
    cfg = get_config(arch) if on_card(device) else get_smoke_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, M.init_params(cfg, gen, device=device)


def where(device) -> str:
    """What a measured row ran on: the card's name, or ``host``."""
    return torch.cuda.get_device_name(device) if on_card(device) else "host"


def device_us(fn, pattern: str) -> tuple:
    """Run ``fn()`` once under ``torch.profiler`` on the card; returns
    ``(us, n)``: the device microseconds of the kernels whose demangled
    name matches ``pattern`` and their number of events. Read from the
    profiler's raw Kineto events (building the Python event tree of a
    window of thousands of launches costs seconds)."""
    from torch._C import _demangle
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rx = re.compile(pattern)
    us, n, names = 0.0, 0, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        raw = ev.name()
        if raw not in names:
            names[raw] = bool(rx.search(_demangle(raw)))
        if names[raw]:
            us += ev.duration_ns() / 1e3
            n += 1
    return us, n
