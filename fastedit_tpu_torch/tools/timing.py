"""Timing a callable on the card with CUDA events: eagerly, and from a CUDA
graph, which leaves the host out; and the host's own cost per call.  Shared
by ``chip_smoke.py`` and the bench scripts of this directory."""

from __future__ import annotations

REPS = 10
GRAPH_CALLS = 20
WARM_SECONDS = 0.02


def _warm(fn) -> None:
    """Call ``fn`` at least once and for ``WARM_SECONDS``: an idle card drops
    its clocks (``nvidia-smi`` read 345 MHz on an idle H100 and 1980 under
    load), which a kernel of tens of microseconds timed right after a pause
    would be read at."""
    import time

    import torch

    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t < WARM_SECONDS:
        fn()
        torch.cuda.synchronize()


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    (after a warm-up).  Where a call's device time is shorter than the host
    takes to enqueue it (tens of microseconds), this reads the host."""
    import torch

    _warm(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = REPS, calls: int = GRAPH_CALLS) -> float:
    """Device milliseconds per call of ``fn`` with the host left out: the
    mean over ``reps`` replays of a CUDA graph that holds ``calls`` calls."""
    import torch

    fn()  # what the first call sets up (a build, a limit raised) stays outside the capture
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    return time_ms(graph.replay, reps) / calls


def host_us(fn, launches: int = 200, trials: int = 7) -> tuple[float, float]:
    """Host microseconds per call of ``fn``: the wall time of ``launches``
    calls up to the last call's return (the enqueue alone: a wrapper's checks,
    its plan, the tensor-map encodings, the launch) and up to one synchronise
    after it (the larger of that and the device's time per call); the least of
    ``trials`` runs, since the host is shared and its clock spreads."""
    import time

    import torch

    _warm(fn)
    enqueue = synced = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(launches):
            fn()
        enqueue = min(enqueue, time.perf_counter() - t)
        torch.cuda.synchronize()
        synced = min(synced, time.perf_counter() - t)
    return 1e6 * enqueue / launches, 1e6 * synced / launches
