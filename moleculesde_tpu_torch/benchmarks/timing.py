"""Device timings on the GPU, one method for ``chip_smoke.py`` and the
profile scripts, and the block phase stamps of a kernel source built with
``-DPHASE_PROFILE`` (``csrc/hopper.cuh``)."""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import time

import numpy as np
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


def phase_library(name: str, source=None) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (or the file ``source``) built with
    ``-DPHASE_PROFILE`` (the port's ``nvcc`` flags otherwise) into
    ``build/profile/lib<name>_phases.so``, loaded."""
    from moleculesde_tpu_torch.kernels import build

    out = build.BUILD_DIR.parent / "profile"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}_phases.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DPHASE_PROFILE", "-o", str(lib),
                    str(source or build.CSRC_DIR / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def phase_stamps(lib: ctypes.CDLL, blocks: int, slots: int, launch) -> np.ndarray:
    """[blocks, slots] ``%globaltimer`` stamps (ns) of one ``launch`` of a
    :func:`phase_library` kernel, after three launches of warm-up."""
    for _ in range(3):
        launch()
    stamps = torch.zeros(blocks * slots, dtype=torch.int64, device="cuda")
    lib.set_phase_profile(ctypes.c_void_p(stamps.data_ptr()))
    launch()
    torch.cuda.synchronize()
    lib.set_phase_profile(ctypes.c_void_p(0))
    return stamps.view(blocks, slots).cpu().numpy()


def print_phase_stamps(title: str, p: np.ndarray, phases) -> None:
    """The span from the first block's start to the last block's end, the
    median block time, the median of each phase (between consecutive marks)
    and the quantiles of the blocks' start times, which show the waves.
    Rows of blocks that never ran (no first stamp) are left out."""
    p = p[:, :len(phases) + 1]
    p = p[p[:, 0] > 0]
    t0 = p[:, 0].min()
    dur = (p[:, -1] - p[:, 0]) / 1e3
    step = np.median(np.diff(p, axis=1), axis=0) / 1e3
    starts = np.sort(p[:, 0] - t0) / 1e3
    print(f"{title}: span {(p[:, -1].max() - t0) / 1e3:.2f} us, block median {np.median(dur):.2f} "
          f"us (min {dur.min():.2f}, max {dur.max():.2f})", flush=True)
    print("  phase medians us: " + ", ".join(f"{k} {v:.2f}" for k, v in zip(phases, step)))
    print("  block start quantiles us (0, 25, 50, 75, 100%): "
          + ", ".join(f"{np.quantile(starts, q):.1f}" for q in (0, 0.25, 0.5, 0.75, 1.0)))
