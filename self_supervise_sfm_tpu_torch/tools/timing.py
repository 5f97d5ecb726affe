"""The CUDA-event timers of ``chip_smoke.py`` and the ablation tools: one
definition of a per-call time and one of a back-to-back time for the repo.

A per-call time is the median of ``reps`` calls, each between its own two
events, so it includes the host's launch cost wherever that exceeds the
device's work. A back-to-back time is the mean of ``reps`` calls queued
between two events behind a ~20 ms spin of the device
(``torch.cuda._sleep``): the host queues every call before the device
reaches the first, so the calls run back to back even where one call's host
cost (tens of microseconds of Python) exceeds its device time or the host
stalls.
"""

from __future__ import annotations

import statistics

import torch

# cycles the device spins before a back-to-back run: ~20 ms at 1.98 GHz
SPIN_CYCLES = 40_000_000


def per_call_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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


def back_to_back_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
