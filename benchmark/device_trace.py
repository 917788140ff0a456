"""The traced sub-window: ``torch.profiler`` over a few seconds of a run, and
the reductions the per-layer metrics read.

A :class:`Trace` holds the profiled span's events as plain records (name,
on the device or not, start and end in ns on the profiler's clock) and answers: the device's busy time
(the union of its kernels, copies and sets), device seconds by kernel
family (``families.json``, first match wins), the longest device operations,
and the longest idle gaps with what the host was doing in them (the
benchmark's own ``bench.*`` spans, else the innermost host operation).
"""

from __future__ import annotations

import json
import os

import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def families() -> list:
    """``[(family, [name parts])]`` in match order."""
    with open(os.path.join(_HERE, "families.json")) as f:
        return [(row["family"], row["match"]) for row in json.load(f)["families"]]


def family_of(name: str, table: list) -> str:
    low = name.lower()
    for fam, parts in table:
        if any(p in low for p in parts):
            return fam
    return "other"


def span(name: str):
    """A benchmark span on the host, seen by the profiler when one runs."""
    return torch.profiler.record_function(name)


class Trace:
    """What the profiler saw between :meth:`start` and :meth:`stop`."""

    def __init__(self, device: torch.device):
        self.device = device
        self._acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self._acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=self._acts)
        self.events: list = []
        self.t0_ns = self.t1_ns = 0
        self.start_s = self.stop_s = 0.0

    def prime(self) -> None:
        """An empty span of a throwaway profiler, so that the profiler's
        one-time start-up falls in set-up and not in the window."""
        p = torch.profiler.profile(activities=self._acts)
        p.start()
        p.stop()

    def start(self) -> None:
        t = time.perf_counter()
        self._prof.start()
        self.start_s = time.perf_counter() - t

    def stop(self) -> None:
        """Ends the profiled span.  The events are read later, by
        :meth:`collect`: reading them holds the interpreter for seconds,
        which would stall whatever thread drives the traffic."""
        t = time.perf_counter()
        self._prof.stop()
        self.stop_s = time.perf_counter() - t

    def collect(self) -> None:
        """The profiled span's events as plain records, once the traffic is over."""
        out = []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            on_device = not str(e.device_type()).endswith("CPU")
            kind = e.activity_type() if hasattr(e, "activity_type") else (
                # older releases: the device's own annotations carry the host span's name
                "gpu_user_annotation" if name.startswith("bench.") else "kernel")
            out.append(dict(name=name, gpu=on_device and kind in _DEVICE_KINDS,
                            t0=e.start_ns(), t1=e.start_ns() + e.duration_ns()))
        self.events = out
        if out:  # the span: the first recorded event's start to the last one's end
            self.t0_ns, self.t1_ns = min(e["t0"] for e in out), max(e["t1"] for e in out)

    # -------------------------------------------------------------- reductions

    @property
    def span_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def device_events(self) -> list:
        return sorted((e for e in self.events if e["gpu"]), key=lambda e: e["t0"])

    def busy_s(self) -> float:
        """Seconds of the span in which some device operation ran."""
        total, end = 0, self.t0_ns
        for e in self.device_events():
            a, b = max(e["t0"], end), min(e["t1"], self.t1_ns)
            if b > a:
                total += b - a
            end = max(end, min(e["t1"], self.t1_ns))
        return total / 1e9

    def family_s(self, table: list) -> dict:
        out = {}
        for e in self.device_events():
            fam = family_of(e["name"], table)
            out[fam] = out.get(fam, 0.0) + (e["t1"] - e["t0"]) / 1e9
        return out

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for e in self.device_events():
            by[e["name"]] = by.get(e["name"], 0.0) + (e["t1"] - e["t0"]) / 1e9
        return sorted(([k[:160], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches with no device operation, each named
        by the host span open at its middle: a ``bench.*`` span if one is,
        else the shortest host operation covering it, else ``host idle``."""
        devs = self.device_events()
        gaps, end = [], self.t0_ns
        for e in devs:
            if e["t0"] > end:
                gaps.append((end, e["t0"]))
            end = max(end, e["t1"])
        if self.t1_ns > end:
            gaps.append((end, self.t1_ns))
        host = [e for e in self.events if not e["gpu"]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) // 2
            over = [e for e in host if e["t0"] <= mid <= e["t1"]]
            bench = [e for e in over if e["name"].startswith("bench.")]
            pick = min(bench or over, key=lambda e: e["t1"] - e["t0"]) if over else None
            out.append([pick["name"][:160] if pick else "host idle", (b - a) / 1e9])
        return out
