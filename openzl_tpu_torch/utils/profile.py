"""Device profile of one call: busy share, device time by kernel, and the
host's kernel launches and synchronizations.

`profile(fn)` runs `fn` once under `torch.profiler` (CPU and CUDA
activities, the CUPTI trace) and reduces the raw trace to a `Profile`:

  wall_ms     host wall-clock time of the call
  busy_ms     union of the device's activity spans (kernels, copies, sets)
  busy_share  busy_ms / wall_ms; 1 - busy_share is the device's idle share
  span_ms     first device start to last device end
  kernels     (total device ms, count, name) per kernel name, largest first
  launches    (count, host ms) of the runtime's kernel-launch calls
  syncs       (count, host ms) of the runtime's synchronize calls, the
              closing `torch.cuda.synchronize` included

`chip_smoke.py` runs it on one warm prove request of the slice.
On a CPU tensor path the trace holds no device events, so `busy_ms` is 0:
the numbers are the card's only when `fn` ran there.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Tuple

import torch


@dataclasses.dataclass
class Profile:
    wall_ms: float
    busy_ms: float
    span_ms: float
    device_events: int
    kernels: List[Tuple[float, int, str]]
    launches: Tuple[int, float]
    syncs: Tuple[int, float]

    @property
    def busy_share(self) -> float:
        return self.busy_ms / self.wall_ms if self.wall_ms else 0.0

    def lines(self, top: int = 25) -> List[str]:
        """A printable report: the totals, then the `top` kernels."""
        out = [
            f"wall {self.wall_ms:.3f} ms; device events {self.device_events}; device busy (union) "
            f"{self.busy_ms:.3f} ms = {100 * self.busy_share:.2f}% busy; first-to-last device "
            f"span {self.span_ms:.3f} ms",
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
    launches, syncs = [0, 0], [0, 0]
    for ev in prof.profiler.kineto_results.events():
        name, dur = ev.name(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            spans.append((ev.start_ns(), ev.start_ns() + dur))
            per_kernel[name][0] += dur
            per_kernel[name][1] += 1
        elif "LaunchKernel" in name:
            launches[0] += 1
            launches[1] += dur
        elif "Synchronize" in name:
            syncs[0] += 1
            syncs[1] += dur
    kernels = sorted(((ns / 1e6, n, name) for name, (ns, n) in per_kernel.items()), reverse=True)
    span = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e6 if spans else 0.0
    return Profile(
        wall_ms=wall, busy_ms=_union_ms(spans), span_ms=span, device_events=len(spans),
        kernels=kernels, launches=(launches[0], launches[1] / 1e6), syncs=(syncs[0], syncs[1] / 1e6),
    )
