"""torch.profiler around a launcher's timed run: the top device kernels
and host ops by self time, and the device's busy share (summed kernel time
over the traced wall time).  Used by ``launch.serve`` and ``launch.train``
(``--profile N``).  Also the allocator's history around a block and what
of it is live at its peak (``memory_history``, ``live_at_peak``), which
``chip_smoke.py`` prints for the reversible and stored-activation
backward."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def maybe_profile(top: int, dev):
    if not top:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def print_profile(prof, top: int, wall_s: float):
    """Top device kernels and top host ops by self time, and the device busy
    share: summed kernel time over the traced wall time.  Only device-side
    events are summed — an aten op's device time is its kernels' time, which
    the kernels' own events already carry."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in kernels)
    print(f"[profile] wall {wall_s:.3f} s; kernel time {busy_us / 1e6:.3f} s "
          f"over {sum(e.count for e in kernels)} launches of {len(kernels)} "
          f"kernels (device busy share {busy_us / 1e6 / wall_s:.3f})")
    for title, evs, key in (("device kernels", kernels, dev_us),
                            ("host ops", host,
                             lambda e: e.self_cpu_time_total)):
        print(f"[profile] top {top} {title} by self time:")
        for e in sorted(evs, key=key, reverse=True)[:top]:
            print(f"[profile]   {key(e) / 1e3:10.3f} ms  {e.count:7d} calls  "
                  f"{e.key[:90]}")


@contextlib.contextmanager
def memory_history(max_entries: int = 1 << 22):
    """Record the CUDA caching allocator's allocations and frees, each
    allocation with its Python stack, while the block runs.  Yields a dict
    whose ``"snapshot"`` (``torch.cuda.memory._snapshot()``) is filled when
    the block ends; read it with ``live_at_peak``."""
    import torch
    out = {}
    torch.cuda.memory._record_memory_history(
        context="alloc", stacks="python", max_entries=max_entries)
    try:
        yield out
        out["snapshot"] = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)


def live_at_peak(snapshot, device: int = 0, root: str = "repro_torch",
                 top: int = 8):
    """The blocks allocated during the recording and still live at its
    peak of allocated bytes, grouped by block size and by the innermost
    frame in a file under ``root`` ("no Python frame": an autograd engine
    thread running a built-in op's backward).

    Returns (peak bytes above the recording's start, rows) with rows
    ``(bytes, count, block bytes, site)``, largest first, at most ``top``.
    """
    trace = snapshot["device_traces"][device]
    live, cur, peak, peak_at = {}, 0, 0, -1
    for n, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > peak:
                peak, peak_at = cur, n
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    live = {}
    for e in trace[:peak_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    groups = {}
    for e in live.values():
        site = next((f"{f['filename'].split(root + '/')[-1]}:{f['line']} "
                     f"{f['name']}" for f in e.get("frames", ())
                     if root + "/" in f["filename"]), "no Python frame")
        b, c = groups.get((site, e["size"]), (0, 0))
        groups[(site, e["size"])] = (b + e["size"], c + 1)
    rows = sorted(((b, c, size, site) for (site, size), (b, c)
                   in groups.items()), reverse=True)
    return peak, rows[:top]
