"""`openzl_tpu_torch.utils.profile` on the CPU: a run with no device
activity reports its wall time and zero device time, and the report's span
union merges overlapping device spans."""

import torch

from openzl_tpu_torch.utils import profile


def test_profile_of_a_cpu_call_has_no_device_time():
    x = torch.arange(1 << 12, dtype=torch.int64)
    report = profile.profile(lambda: (x * x).sum())
    assert report.wall_ms > 0
    assert (report.device_events, report.busy_ms, report.busy_share) == (0, 0.0, 0.0)
    assert report.launches == (0, 0.0)
    lines = report.lines()
    assert len(lines) == 3 and "0.00% busy" in lines[0]


def test_span_union_merges_overlaps():
    ns = 1_000_000
    spans = [(0, 2 * ns), (1 * ns, 3 * ns), (5 * ns, 6 * ns), (5 * ns, 5 * ns + ns // 2)]
    assert profile._union_ms(spans) == 4.0
