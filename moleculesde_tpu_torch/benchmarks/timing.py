"""Device timings on the GPU, one method for ``chip_smoke.py`` and the
profile scripts."""

from __future__ import annotations

import statistics
import time

import torch


def median_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the graph replayed and timed with CUDA events (median of 10
    replays after 2), divided by ``reps``.  Unlike the CUDA-event median of
    single calls it leaves out the host's time between launches, which for
    a kernel of a few microseconds is most of the event time; what is left
    beside the kernels are the card's own gaps between launches."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = median_ms(graph.replay, warmup=2, reps=10) / reps
    del graph
    return ms


def profiled_ms(fn):
    """(wall ms, device-busy ms) of one call of ``fn`` under
    ``torch.profiler`` (CPU and CUDA activities): the host clock around the
    call and its synchronize, and the sum of the device times of its CUDA
    events (one stream), as the profile scripts count them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall_ms, busy_us / 1e3
