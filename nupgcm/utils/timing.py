"""Timing / profiling subsystem.

Parity-plus for the reference's opt-in timing (reference
src/nuPGCM.jl:57-72 ``ENABLE_TIMING``/``@ctime``; solver stats via
``@debug``, src/iterative_solvers.jl:60-65): structured per-phase
wall-clock timers with enable/disable, plus helpers to dump a
``jax.profiler`` trace of the device timeline.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

ENABLE_TIMING = {"on": False}


def set_timing(on: bool = True):
    ENABLE_TIMING["on"] = bool(on)


class Timers:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def __call__(self, name: str, block_on=None):
        if not ENABLE_TIMING["on"]:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def report(self) -> str:
        lines = ["timers:"]
        for name in sorted(self.total, key=lambda k: -self.total[k]):
            n = self.count[name]
            t = self.total[name]
            lines.append(f"  {name}: {t:.3f}s total, {n} calls, {t / n * 1e3:.2f} ms/call")
        return "\n".join(lines)

    def reset(self):
        self.total.clear()
        self.count.clear()


TIMERS = Timers()


def memory_status() -> str:
    """Host + device memory report (reference ``print_memory_status``,
    src/architectures.jl:19-20 / ext/nuPGCMCUDAExt.jl:33): host maxrss
    and, per device, the allocator's ``memory_stats``."""
    import resource

    import jax

    maxrss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lines = [f"host maxrss: {maxrss_kb / 1048576:.2f} GB"]
    for d in jax.local_devices():
        stats = d.memory_stats()
        if stats:
            used = stats.get("bytes_in_use", 0) / 2**30
            lim = stats.get("bytes_limit", 0) / 2**30
            peak = stats.get("peak_bytes_in_use", 0) / 2**30
            lines.append(f"{d}: {used:.2f} / {lim:.2f} GB in use "
                         f"(peak {peak:.2f} GB)")
        else:
            lines.append(f"{d}: no memory stats from this backend")
    return "\n".join(lines)


def print_memory_status():
    print(memory_status(), flush=True)


@contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace (view with TensorBoard or
    xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
