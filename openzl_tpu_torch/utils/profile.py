"""Device profile of one call: busy share, device time by kernel, and the
host's kernel launches and synchronizations.

`profile(fn)` runs `fn` once under `torch.profiler` (CPU and CUDA
activities, the CUPTI trace) and reduces the raw trace to a `Profile`:

  wall_ms     host wall-clock time of the call
  busy_ms     union of the device's activity spans (kernels, copies, sets)
  busy_share  busy_ms / wall_ms; 1 - busy_share is the device's idle share
  span_ms     first device start to last device end
  kernels     (total device ms, count, name) per kernel name, largest first
  kernel_events  the device's kernel records (copies and sets left out)
  launches    (count, host ms) of the runtime's kernel-launch calls
  lost        launches with no kernel record
  syncs       (count, host ms) of the runtime's synchronize calls, the
              closing `torch.cuda.synchronize` included

`chip_smoke.py` runs it on one warm prove request of the slice, and
`device_ms` to time single kernels.

On the H100 (torch 2.11, CUDA 12.8) a profile late in a long process can
keep fewer kernel records than the host made launches: a profile of ten K5
launches kept 4 to 6 of them, which made a kernel's device time a fifth
to a tenth of its CUDA-event time in `chip_smoke.py`. The cause is not
known (PERF.md). `device_ms` therefore profiles again until no record is
lost.

On a CPU tensor path the trace holds no device events, so `busy_ms` is 0:
the numbers are the card's only when `fn` ran there.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Profile:
    wall_ms: float
    busy_ms: float
    span_ms: float
    device_events: int
    kernels: List[Tuple[float, int, str]]
    kernel_events: int
    launches: Tuple[int, float]
    syncs: Tuple[int, float]

    @property
    def busy_share(self) -> float:
        return self.busy_ms / self.wall_ms if self.wall_ms else 0.0

    @property
    def lost(self) -> int:
        """Host kernel launches with no device record (0 when the trace is
        whole)."""
        return max(self.launches[0] - self.kernel_events, 0)

    def lines(self, top: int = 25) -> List[str]:
        """A printable report: the totals, then the `top` kernels."""
        out = [
            f"wall {self.wall_ms:.3f} ms; device events {self.device_events}; device busy (union) "
            f"{self.busy_ms:.3f} ms = {100 * self.busy_share:.2f}% busy; first-to-last device "
            f"span {self.span_ms:.3f} ms; kernel records {self.kernel_events} ({self.lost} launches "
            f"without one)",
            f"host: {self.launches[0]} kernel launches ({self.launches[1]:.3f} ms), "
            f"{self.syncs[0]} synchronizations ({self.syncs[1]:.3f} ms)",
            f"device time by kernel (top {top}): total ms, count, name",
        ]
        out += [f"{ms:10.3f} {n:7d}  {name[:110]}" for ms, n, name in self.kernels[:top]]
        return out


def _union_ms(spans) -> float:
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def profile(fn: Callable[[], object]) -> Profile:
    """Run `fn` once under the profiler; synchronizes the card before and
    after when CUDA is available."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, per_kernel = [], collections.defaultdict(lambda: [0, 0])
    launches, syncs, kernel_events = [0, 0], [0, 0], 0
    for ev in prof.profiler.kineto_results.events():
        name, dur = ev.name(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            spans.append((ev.start_ns(), ev.start_ns() + dur))
            per_kernel[name][0] += dur
            per_kernel[name][1] += 1
            kernel_events += not name.startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in name:
            launches[0] += 1
            launches[1] += dur
        elif "Synchronize" in name:
            syncs[0] += 1
            syncs[1] += dur
    kernels = sorted(((ns / 1e6, n, name) for name, (ns, n) in per_kernel.items()), reverse=True)
    span = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e6 if spans else 0.0
    return Profile(
        wall_ms=wall, busy_ms=_union_ms(spans), span_ms=span, device_events=len(spans), kernels=kernels,
        kernel_events=kernel_events, launches=(launches[0], launches[1] / 1e6), syncs=(syncs[0], syncs[1] / 1e6),
    )


#: profiles taken by `device_ms`, and how many of them lost a kernel record
DEVICE_MS_PROFILES = {"taken": 0, "lost": 0}


def device_ms(fn: Callable[[], object], reps: int, tries: int = 5) -> Optional[float]:
    """Device ms per call of fn on the card: its kernels' durations summed
    over `reps` calls under one profile, over `reps`, without the host's
    cost of a launch. fn must launch as many kernels on every call. A
    profile has lost a record when a host launch has no kernel record, or
    when the kernel records are not a whole number of calls (a host record
    lost with its kernel's); it is profiled again, up to `tries` times.
    None off the card, when no kernel ran, or when every try lost one."""
    if not torch.cuda.is_available():
        return None
    fn()
    for _ in range(tries):
        report = profile(lambda: [fn() for _ in range(reps)])
        lost = report.lost or report.kernel_events % reps
        DEVICE_MS_PROFILES["taken"] += 1
        DEVICE_MS_PROFILES["lost"] += bool(lost)
        if report.kernels and not lost:
            return sum(ms for ms, _, _ in report.kernels) / reps
    return None
