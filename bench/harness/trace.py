"""The device trace of a window: kernel records, busy time, idle gaps.

``profiled(fn)`` runs ``fn()`` under ``torch.profiler`` (CUDA activity
only), bracketed by sentinel kernels: the tracer can drop a window's first
records, so the records count only when a sentinel leads and one trails
(then every record of ``fn`` in between was kept); otherwise the window
runs again with a longer pad.  A thread samples what the host was doing
(the innermost frame of the port or of the benchmark) every ``SAMPLE_S``,
so each idle gap on the device can be named by it; sampling more often
slows the launching thread, which holds the interpreter's lock.

The arithmetic (the busy union, the sentinel pad) is copied from the
repository's ``chip_smoke.py`` (``profiled``, ``kernel_time``).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import threading
import time

SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel, launched nowhere else
SAMPLE_S = 0.01


@dataclasses.dataclass
class Window:
    kernels: list          # (name, start_s, end_s), work kernels only, sorted
    wall_s: float          # host wall of fn(), ending in a synchronize
    samples: list          # (host_s, label) taken while fn() ran
    start_s: float         # fn()'s start on the kernels' clock
    end_s: float

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.kernels))

    def by_name(self) -> list:
        """``[name, seconds, launches]`` per kernel name, most time first."""
        acc: dict = collections.defaultdict(lambda: [0.0, 0])
        for name, s, e in self.kernels:
            acc[name][0] += e - s
            acc[name][1] += 1
        return sorted(([k, *v] for k, v in acc.items()), key=lambda r: -r[1])

    def idle_by_host(self) -> list:
        """``[label, seconds]``: the device's idle time inside the window,
        each gap named by what the host was doing in most of its samples
        (in the sample nearest its start where it holds none), summed per
        name, longest first."""
        gaps, cur = [], self.start_s
        for s, e in merged(self.kernels):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.end_s > cur:
            gaps.append((cur, self.end_s))
        times = [t for t, _ in self.samples]
        acc: dict = collections.defaultdict(float)
        for s, e in gaps:
            lo, hi = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            if hi > lo:
                labels = collections.Counter(
                    lab for _, lab in self.samples[lo:hi])
                name = labels.most_common(1)[0][0]
            elif times:
                near = min((i for i in (lo - 1, lo) if 0 <= i < len(times)),
                           key=lambda i: abs(times[i] - s))
                name = self.samples[near][1]
            else:
                name = "(unsampled)"
            acc[name] += e - s
        return sorted(([k, v] for k, v in acc.items()), key=lambda r: -r[1])


def merged(kernels) -> list:
    """The union of the kernels' intervals as sorted disjoint pairs."""
    out = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


class _HostSampler:
    """Samples the main thread's innermost frame of the port or of the
    benchmark every ``SAMPLE_S`` seconds."""

    def __init__(self, roots: tuple):
        self.roots = roots
        self.samples: list = []
        self._stop = threading.Event()
        self._main = threading.main_thread().ident
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _label(self, frame) -> str:
        f = frame
        while f is not None:
            path = f.f_code.co_filename
            for root in self.roots:
                i = path.find(root)
                if i >= 0:
                    return f"{path[i:]}:{f.f_code.co_name}"
            f = f.f_back
        return f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:" \
               f"{frame.f_code.co_name}"

    def _run(self):
        while not self._stop.is_set():
            frame = sys._current_frames().get(self._main)
            if frame is not None:
                self.samples.append((time.perf_counter(), self._label(frame)))
            del frame
            time.sleep(SAMPLE_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            raise RuntimeError("host sampler thread did not stop")


def profiled(fn, roots=("repro_torch/", "bench/")) -> Window:
    """``fn()`` under the profiler: its work kernels, host wall and host
    samples (see the module docstring).  Raises when every try lost
    records at an edge."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for pad in (256, 4096, 32768):
        torch.cuda.synchronize()
        with _HostSampler(roots) as sampler:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05)  # let the tracer settle before launching
                for _ in range(pad):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                h1 = time.perf_counter()
                for _ in range(pad):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        events = sorted(
            ((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
             for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA),
            key=lambda k: k[1])
        work = [i for i, k in enumerate(events) if SENTINEL not in k[0]]
        lead = work[0] if work else len(events)
        trail = len(events) - 1 - work[-1] if work else len(events)
        if lead and trail:
            # The host's clock mapped onto the kernels' clock: fn() starts
            # when the last leading sentinel ends (the host waited for it).
            d0 = events[lead - 1][2]
            offset = d0 - h0
            samples = [(t + offset, lab) for t, lab in sampler.samples
                       if h0 <= t <= h1]
            return Window(kernels=[events[i] for i in work], wall_s=h1 - h0,
                          samples=samples, start_s=d0, end_s=h1 + offset)
        print(f"profiler window with a pad of {pad} kept {lead} leading and "
              f"{trail} trailing sentinels; again with a longer pad",
              file=sys.stderr)
    raise RuntimeError("the profiler lost records at the edge of every "
                       "window, so no kernel count can be trusted")
