"""`openzl_tpu_torch.utils.profile` on the CPU: a run with no device
activity reports its wall time and zero device time, the report's span
union merges overlapping device spans, and `device_ms` profiles again
while a profile has lost a kernel record (the profiler stood in for)."""

import torch

from openzl_tpu_torch.utils import profile


def test_profile_of_a_cpu_call_has_no_device_time():
    x = torch.arange(1 << 12, dtype=torch.int64)
    report = profile.profile(lambda: (x * x).sum())
    assert report.wall_ms > 0
    assert (report.device_events, report.busy_ms, report.busy_share) == (0, 0.0, 0.0)
    assert report.launches == (0, 0.0)
    assert (report.kernel_events, report.lost) == (0, 0)
    lines = report.lines()
    assert len(lines) == 3 and "0.00% busy" in lines[0]


def test_span_union_merges_overlaps():
    ns = 1_000_000
    spans = [(0, 2 * ns), (1 * ns, 3 * ns), (5 * ns, 6 * ns), (5 * ns, 5 * ns + ns // 2)]
    assert profile._union_ms(spans) == 4.0


def _report(kernels, kernel_events, launches):
    return profile.Profile(wall_ms=1.0, busy_ms=0.0, span_ms=0.0, device_events=kernel_events, kernels=kernels,
                           kernel_events=kernel_events, launches=(launches, 0.0), syncs=(0, 0.0))


def test_device_ms_profiles_again_while_a_record_is_lost(monkeypatch):
    """`device_ms` (the device time `chip_smoke.py` prints) takes the first
    profile that kept a kernel record for every host launch, and gives up
    (None) when every try lost one; off the card it is None."""
    assert profile.device_ms(lambda: None, 3) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    whole = _report([(3.0, 3, "k")], 3, 3)
    reports = iter([_report([(2.0, 2, "k")], 2, 3), _report([(1.0, 1, "k")], 1, 3), whole])
    monkeypatch.setattr(profile, "profile", lambda fn: next(reports))
    before = dict(profile.DEVICE_MS_PROFILES)
    assert profile.device_ms(lambda: None, 3) == 1.0
    assert profile.DEVICE_MS_PROFILES["taken"] - before["taken"] == 3
    assert profile.DEVICE_MS_PROFILES["lost"] - before["lost"] == 2
    assert whole.lost == 0 and _report([], 1, 3).lost == 2
    monkeypatch.setattr(profile, "profile", lambda fn: _report([(2.0, 2, "k")], 2, 3))
    assert profile.device_ms(lambda: None, 3) is None


def test_device_ms_profiles_again_when_a_host_record_is_lost_too(monkeypatch):
    """A profile whose kernel records are not a whole number of calls lost
    a host launch with its kernel record, which `Profile.lost` cannot see:
    `device_ms` profiles again."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    short = _report([(2.0, 2, "k")], 2, 2)
    assert short.lost == 0
    reports = iter([short, _report([(6.0, 6, "k")], 6, 6)])
    monkeypatch.setattr(profile, "profile", lambda fn: next(reports))
    before = dict(profile.DEVICE_MS_PROFILES)
    assert profile.device_ms(lambda: None, 3) == 2.0
    assert profile.DEVICE_MS_PROFILES["lost"] - before["lost"] == 1
