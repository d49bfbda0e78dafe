"""The device's activity over a short stretch of update calls, from
``torch.profiler``'s raw trace: every kernel, copy and fill with its start
and length, the seconds in which any of them ran, and the host's clock
around the stretch; and, over one more update with the host's operations
traced too, what the host was doing in each gap in the device's work."""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

NAME_CHARS = 160  # of a kernel name in the breakdown
LABEL = "portbench."  # the harness's labels of the host's phases (hooks.Labels)


def _on_device(event) -> bool:
    """A kernel, copy or fill: an event on the device that is not a range of
    a label (``record_function``, the harness's or another), which the
    profiler also draws on the device's timeline."""
    return (event.device_type() == DeviceType.CUDA and not event.is_user_annotation()
            and not event.name().startswith(LABEL))


def _on_host(event) -> bool:
    """An operation or label on the host; not a call of the CUDA runtime."""
    return event.device_type() == DeviceType.CPU and not event.name().startswith("cuda")


def _device_events(prof) -> list[tuple[str, int, int]]:
    return sorted(((e.name(), e.start_ns(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if _on_device(e)),
                  key=lambda e: e[1])


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_ns(events) -> int:
    """Nanoseconds in which at least one device operation ran."""
    total, end = 0, None
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        if end is None or start > end:
            total += dur
            end = start + dur
        elif start + dur > end:
            total += start + dur - end
            end = start + dur
    return total


def gaps(events, min_ns: int = 1000) -> list[tuple[int, int]]:
    """(start, end) of each stretch of at least ``min_ns`` with nothing on
    the device, between its first operation and its last."""
    out, end = [], None
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        if end is not None and start - end >= min_ns:
            out.append((end, start))
        end = start + dur if end is None else max(end, start + dur)
    return out


def top_ops(events, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time, ``[name, seconds]``."""
    total = defaultdict(int)
    for name, _, dur in events:
        total[name[:NAME_CHARS]] += dur
    return [[name, ns / 1e9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def name_gaps(gap_list, host_ops, n: int = 10) -> list[list]:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost host operation then, under the harness's label of the phase
    (``[name, seconds]``, the ``n`` largest)."""
    total = defaultdict(int)
    for lo, hi in gap_list:
        mid = (lo + hi) // 2
        around = [(start, name) for name, start, end in host_ops if start <= mid <= end]
        labels = [name for start, name in sorted(around) if name.startswith(LABEL)]
        inner = max(around)[1] if around else "no host operation"
        total[f"{labels[-1] if labels else 'portbench.other'} > {inner}"] += hi - lo
    return [[name, ns / 1e9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def device_stretch(run_calls) -> dict:
    """``run_calls()`` under the profiler, device activity only."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run_calls()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    events = _device_events(prof)
    return {"events": events, "window_s": window_s, "busy_s": busy_ns(events) / 1e9}


def host_stretch(run_calls) -> list[list]:
    """``run_calls()`` with the host traced too: the named idle gaps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_calls()
        torch.cuda.synchronize()
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if _on_host(e)]
    return name_gaps(gaps(_device_events(prof)), host)
