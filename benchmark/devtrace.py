"""The device trace of a traced run, read from ``torch.profiler``.

On the card host a profiler session loses the device records of its
first launches once kernels loaded outside PyTorch have run (up to some
hundred of them), so a session opens with ``PAD`` empty launches and a
synchronise before the window starts; the window's own records are
those that start inside it.
"""

from __future__ import annotations

import bisect
import time

import torch

PAD = 256
#: Kernel names of the port's flash kernels, by the kernel they count
#: for (either route).
FLASH_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_simt_kernel"),
    "flash_bwd": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_simt_kernel",
                  "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_simt_kernel"),
}
#: Activities that are work on the device (the device-side copies of
#: the harness's annotations, "gpu_user_annotation", are not).
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Harness spans an idle gap may fall in, innermost first.
SPAN_ORDER = ("prefill", "engine_tick", "gateway_tick", "train_micro_step",
              "score_step")


class Session:
    """One profiler session over a window on the card."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()
        pad = torch.zeros(1, device=self.device)
        for _ in range(PAD):
            pad.add_(1)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof.stop()

    def events(self):
        """(device kernels, harness spans): lists of (name, start ns,
        end ns) on the host's monotonic clock."""
        evs = self.prof.profiler.kineto_results.events()
        # the profiler's clock is the wall clock; shift to monotonic
        shift = time.monotonic_ns() - time.time_ns()
        kernels, spans = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in evs:
            name = e.name()
            start = e.start_ns() + shift
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                # the device-side copy of a harness annotation bears the
                # span's name; it is no work
                if name not in SPAN_ORDER and not _annotation(e):
                    kernels.append((name, start, end))
            elif name in SPAN_ORDER:
                spans.append((name, start, end))
        return kernels, spans


def _annotation(e) -> bool:
    for attr in ("activity_type", "is_user_annotation"):
        f = getattr(e, attr, None)
        if f is not None:
            v = f()
            return v not in DEVICE_ACTIVITIES if isinstance(v, str) else bool(v)
    return False


def _span_index(spans: list) -> dict:
    idx: dict[str, tuple[list, list]] = {}
    for name, a, b in sorted(spans, key=lambda x: x[1]):
        starts, ends = idx.setdefault(name, ([], []))
        starts.append(a)
        ends.append(b)
    return idx


def _where(idx: dict, t: int) -> str:
    for name in SPAN_ORDER:
        if name in idx:
            starts, ends = idx[name]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] > t:
                return name
    return "between_quanta"


def summarize(kernels: list, spans: list, t0: int, t1: int) -> dict:
    """Busy time (the union of kernel intervals), kernel time by name
    and by flash kernel, and idle time by the harness span the host was
    in at the middle of each gap, over the kernels that start in
    [t0, t1)."""
    ks = sorted((s, min(e, t1), n) for n, s, e in kernels if t0 <= s < t1)
    by_name: dict[str, list] = {}
    busy = 0
    gaps = []
    last_end = t0
    for s, e, n in ks:
        rec = by_name.setdefault(n, [0, 0])
        rec[0] += 1
        rec[1] += e - s
        if s > last_end:
            gaps.append((last_end, s))
        busy += max(0, e - max(s, last_end))
        last_end = max(last_end, e)
    if t1 > last_end:
        gaps.append((last_end, t1))
    idx = _span_index(spans)
    idle_by_span: dict[str, int] = {}
    for g0, g1 in gaps:
        where = _where(idx, (g0 + g1) // 2)
        idle_by_span[where] = idle_by_span.get(where, 0) + (g1 - g0)
    flash = {}
    for kernel, names in FLASH_KERNELS.items():
        hits = [v for n, v in by_name.items() if any(k in n for k in names)]
        if hits:
            flash[kernel] = {"launches": sum(v[0] for v in hits),
                             "ns": sum(v[1] for v in hits)}
    return {"busy_ns": busy, "window_ns": t1 - t0, "kernels": by_name,
            "flash": flash, "idle_by_span": idle_by_span,
            "n_kernels": len(ks)}
