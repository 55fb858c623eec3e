"""Reading a ``torch.profiler`` trace of the measured window.

The window's proves and verifies are marked with ``record_function``
ranges of the benchmark's own (``perfbench.prove``, ``perfbench.verify``),
so device time can be set against them on the profiler's clock. The busy
time is the union of the device events' intervals, as in
``spartan_tpu_torch/io/keyless_bench._device_busy``; the top operations
sum each device operation's own time, as ``_device_top`` does.
"""

from __future__ import annotations

PROVE, VERIFY = "perfbench.prove", "perfbench.verify"


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of the trace. The
    ranges the benchmark marks appear on the device's timeline too, as user
    annotations: they are marks, not device work, and are left out there."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() == DeviceType.CUDA
        if not (dev and ev.is_user_annotation()):
            out.append((ev.name(), dev, ev.start_ns() / 1e3, ev.end_ns() / 1e3))
    return out


def union(intervals):
    """Sorted disjoint intervals covering the given ones."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap(a, b) -> float:
    """Total length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(prof, top: int = 10) -> dict:
    """What the traced window shows: ``busy_s`` and ``window_s`` of the
    device over the marked window, ``prove_busy_s`` and ``prove_s`` over the
    proves, the breakdown's ``device_ops`` and ``idle_gaps``, and the
    ``events`` themselves, for readers that pick their own."""
    events = _events(prof)
    device = [(s, e) for _, d, s, e in events if d and e > s]
    proves = union([(s, e) for n, d, s, e in events if not d and n == PROVE])
    marks = union([(s, e) for n, d, s, e in events if not d and n in (PROVE, VERIFY)])
    busy = union(device)
    out = {"device_events": len(device), "events": events}
    if not marks:
        return out
    window = [[marks[0][0], marks[-1][1]]]
    out["window_s"] = (window[0][1] - window[0][0]) / 1e6
    out["busy_s"] = overlap(busy, window) / 1e6
    out["prove_s"] = sum(e - s for s, e in proves) / 1e6
    out["prove_busy_s"] = overlap(busy, proves) / 1e6
    own: dict = {}
    for name, d, s, e in events:
        if d:
            own[name] = own.get(name, 0.0) + (e - s) / 1e6
    out["device_ops"] = [[k, v] for k, v in sorted(own.items(), key=lambda kv: -kv[1])[:top]]
    out["idle_gaps"] = _gaps(busy, proves, events, top)
    return out


def _gaps(busy, proves, events, top: int) -> list:
    """The longest stretches of the proves in which the device ran nothing,
    each named by the host events that overlap it most."""
    gaps = []
    for ps, pe in proves:
        cur = ps
        for s, e in busy:
            if e <= cur or s >= pe:
                continue
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < pe:
            gaps.append((cur, pe))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n not in (PROVE, VERIFY))
    out = []
    for gs, ge in gaps:
        seen: dict = {}
        for s, e, n in host:
            if s >= ge:
                break
            lo, hi = max(s, gs), min(e, ge)
            if hi > lo:
                seen[n] = seen.get(n, 0.0) + hi - lo
        best = max(seen.items(), key=lambda kv: kv[1])[0] if seen else "host, no profiler event"
        out.append([f"{best} (+{(gs - proves[0][0]) / 1e6:.3f} s)", (ge - gs) / 1e6])
    return out
