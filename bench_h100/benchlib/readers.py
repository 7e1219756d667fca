"""What the per-layer readers share: a kernel op's share of its roofline
and the device's idle share, from the traced window."""

from __future__ import annotations

from benchlib import counts


def roofline_pct(run, op: str, least, keep=None) -> float | None:
    """100 x the summed least time of the op's launches in the window
    (``least(shapes)``) over their summed device time; launches for which
    ``keep(launch)`` is false are left out.  None without launches."""
    s = run.tracer.summary
    if s is None:
        return None
    chosen = [x for x in s.launches.get(op, [])
              if keep is None or keep(x)]
    device = sum(x.device_s for x in chosen)
    if not chosen or device <= 0:
        return None
    return 100.0 * sum(least(x.shapes) for x in chosen) / device


def gemm_least(shapes) -> float:
    (m, k), (_, n) = shapes[0], shapes[1]
    return counts.gemm_least_s(m, k, n)


def grouped_least(shapes) -> float:
    (e, c, d), (_, _, f) = shapes[0], shapes[1]
    return counts.grouped_least_s(e, c, d, f)


def is_thin(launch) -> bool:
    """The grouped op's weight-streaming body (its kernel names)."""
    return any("thin_kernel" in k for k in launch.kernels)


def idle_pct(run) -> float | None:
    s = run.tracer.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
