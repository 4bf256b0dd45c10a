"""What a ``torch.profiler`` trace of whole solves says about the device.

:func:`summarize` reads the profiler's raw events once: the device
activities (kernels, graph-replayed kernels included, copies and sets),
and the harness's own spans on the host (``record_function`` around each
call into a layer). From them:

* ``window_s``: from the first span's start to the last one's end;
* ``busy_s``: the union of the device activities' intervals;
* ``device_s``: their summed durations, and ``by_name``: the same by name;
* ``idle_by_span``: each idle stretch of the device within the traced
  window (between activities, and before the first and after the last),
  named by the harness span the host was in at its middle (``"other"``
  outside every span), summed by name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def _events(prof):
    """``(name, device?, start_ns, end_ns)`` of every event, from the
    profiler's raw results where they exist, else from its event list."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            start = e.start_ns()
            yield e.name(), e.device_type() == DeviceType.CUDA, start, start + e.duration_ns()
        return
    for e in prof.events():
        yield (e.name, e.device_type == DeviceType.CUDA, int(e.time_range.start * 1000),
               int(e.time_range.end * 1000))


def summarize(prof, spans) -> dict:
    """The trace's device summary over its window, from the first of the
    harness's ``spans`` to the end of the last (``window_s``), naming idle
    stretches by those spans."""
    device, host = [], []
    by_name = defaultdict(float)
    for name, on_device, start, end in _events(prof):
        if on_device and name not in spans:  # the spans' device-side mirrors are no work
            device.append((start, end))
            by_name[name] += (end - start) / 1e9
        elif name in spans:
            host.append((start, end, name))
    host.sort()
    if not host:
        raise RuntimeError("the trace holds none of the harness's spans")
    t0_ns, t1_ns = host[0][0], max(e for _, e, _ in host)
    device = sorted((max(s, t0_ns), min(e, t1_ns)) for s, e in device if e > t0_ns and s < t1_ns)
    starts = [s for s, _, _ in host]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return host[i][2] if i >= 0 and host[i][1] >= t else "other"

    busy, idle = 0, defaultdict(float)
    cur_s = cur_e = None

    def gap(a, b):
        if b > a:
            idle[span_at((a + b) // 2)] += (b - a) / 1e9

    edge = t0_ns
    for s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                edge = cur_e
            gap(max(edge, t0_ns), min(s, t1_ns))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        edge = cur_e
    gap(max(edge, t0_ns), t1_ns)
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy / 1e9,
            "device_s": sum(by_name.values()), "by_name": dict(by_name),
            "idle_by_span": dict(idle), "activities": len(device)}


def seconds_matching(summary: dict, needle: str) -> float:
    """Device seconds of the activities whose name contains ``needle``
    (letter case ignored)."""
    needle = needle.lower()
    return sum(s for n, s in summary["by_name"].items() if needle in n.lower())


def breakdown(summary: dict, top: int = 10) -> dict:
    """The ``top`` device activities by time and idle stretches by span."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
