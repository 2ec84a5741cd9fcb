"""The traced stretch of a run: ``torch.profiler`` over a few whole chunks,
reduced to device intervals, the chunks' boundaries and a breakdown.

The profiler's Chrome trace holds every kernel with its device interval and
the correlation id of the runtime call that launched it; the harness wraps
each chunk in a ``mdbench.chunk`` range, so a kernel belongs to the chunk
whose range holds its launch. The device is busy where some kernel runs:
the union of kernel intervals, so that kernels that overlap count once.
"""

from __future__ import annotations

import bisect
import json
import os
import pathlib
import re
import tempfile
from typing import List, Optional

import numpy as np

CHUNK_RANGE = "mdbench.chunk"
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def own_kernel_names(package_dir: pathlib.Path) -> set:
    """The program's own kernels: the ``__global__`` functions of its CUDA
    sources and the ``@triton.jit`` functions of its Python modules."""
    names = set()
    for path in package_dir.rglob("*.cu*"):
        text = path.read_text(errors="replace")
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                                r"(\w+)\s*\(", text))
    for path in package_dir.rglob("*.py"):
        text = path.read_text(errors="replace")
        names.update(re.findall(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)", text))
    return names


def base_name(kernel: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments or parameters."""
    name = kernel.replace("(anonymous namespace)", "")
    while True:
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            break
        name = shorter
    ids = re.findall(r"[A-Za-z_]\w*", name.split("(", 1)[0])
    return ids[-1] if ids else kernel


def display_name(kernel: str) -> str:
    """A kernel's qualified name without return type, template arguments or
    parameters, for the breakdown."""
    name = kernel.replace("(anonymous namespace)::", "")
    while True:
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            break
        name = shorter
    head = name.split("(", 1)[0].split()
    return head[-1].strip(":") if head else kernel


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


class Trace:
    """What the metrics read of a traced stretch, in seconds."""

    def __init__(self, events: list, own_names: set):
        kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
        device_ops = [e for e in events if e.get("ph") == "X"
                      and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        launches = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        chunks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") == "user_annotation" and e.get("name") == CHUNK_RANGE)
        self.chunks = len(chunks)
        if not chunks:
            self.window_s = self.busy_s = self.own_s = self.aten_s = 0.0
            self.chunk_gaps, self.breakdown = [], {"device_ops": [], "idle_gaps": []}
            return
        lo, hi = chunks[0][0], chunks[-1][1]
        self.window_s = (hi - lo) * 1e-6
        starts = [c[0] for c in chunks]
        first = [None] * len(chunks)
        last = [None] * len(chunks)
        own = aten = 0.0
        intervals = []
        for k in kernels:
            t0, t1 = k["ts"], k["ts"] + k["dur"]
            if base_name(k["name"]) in own_names:
                own += k["dur"]
            else:
                aten += k["dur"]
            intervals.append((max(t0, lo), min(t1, hi)))
            at = launches.get(k.get("args", {}).get("correlation"))
            c = bisect.bisect_right(starts, at) - 1 if at is not None else -1
            if c >= 0 and at <= chunks[c][1]:
                first[c] = t0 if first[c] is None else min(first[c], t0)
                last[c] = t1 if last[c] is None else max(last[c], t1)
        self.own_s, self.aten_s = own * 1e-6, aten * 1e-6
        busy = _union([iv for iv in intervals if iv[1] > iv[0]])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self.chunk_gaps = [(first[i + 1] - last[i]) * 1e-6 for i in range(len(chunks) - 1)
                           if last[i] is not None and first[i + 1] is not None]
        self.breakdown = {"device_ops": self._top_ops(device_ops),
                          "idle_gaps": self._idle_gaps(busy, lo, hi, events)}

    @staticmethod
    def _top_ops(device_ops: list) -> list:
        by = {}
        for e in device_ops:
            name = display_name(e["name"]) if e["cat"] == "kernel" else e["name"]
            by[name[:96]] = by.get(name[:96], 0.0) + e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]

    @staticmethod
    def _idle_gaps(busy: list, lo: float, hi: float, events: list) -> list:
        """Idle time grouped by what the host was doing at each gap's middle:
        the innermost host range there, under the harness's range."""
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
        if not gaps or not host:
            return []
        h_lo = np.array([e["ts"] for e in host])
        h_hi = h_lo + np.array([e["dur"] for e in host])
        h_dur = h_hi - h_lo
        names = [e["name"] for e in host]
        harness = np.array([e["name"].startswith("mdbench.") for e in host])
        by = {}
        gaps.sort(key=lambda g: g[0] - g[1])
        for a, b in gaps[:2000]:
            mid = 0.5 * (a + b)
            cover = (h_lo <= mid) & (h_hi >= mid)
            if not cover.any():
                label = "no host range"
            else:
                inner = np.flatnonzero(cover)[np.argmin(h_dur[cover])]
                outer = np.flatnonzero(cover & harness)
                outer = names[outer[np.argmin(h_dur[outer])]] if outer.size else "-"
                label = f"{outer} > {names[inner]}" if names[inner] != outer else outer
            by[label[:96]] = by.get(label[:96], 0.0) + (b - a) * 1e-6
        rest = sum(b - a for a, b in gaps[2000:]) * 1e-6
        if rest:
            by["shorter gaps"] = by.get("shorter gaps", 0.0) + rest
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]


class Tracer:
    """``torch.profiler`` started and stopped around whole chunks."""

    def __init__(self, own_names: set):
        self.own_names = own_names
        self._prof = None
        self.trace: Optional[Trace] = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self, work):
        """Trace ``work`` once and drop it: the profiler's first start on a
        process sets up the device tracing, which must not fall in a chunk."""
        with self._profile():
            work()

    def start(self):
        self._prof = self._profile()
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)

    def read(self):
        """Reduce the stopped profile to a ``Trace``."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        self.trace = Trace(events, self.own_names)
