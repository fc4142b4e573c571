"""What the per-layer readers share: a span's device milliseconds per
call, a kernel's roofline share, the whole step's share of the peak."""

from __future__ import annotations

from typing import Any, Callable, Mapping

from ..counts.roofline import BF16_PEAK


def span_ms(ctx: Mapping[str, Any], name: str) -> float | None:
    """Device ms of the operations launched inside the span ``name``, per
    call of it; None where it never opened or launched nothing."""
    seconds, calls = ctx['trace'].span_device(name)
    if not calls or seconds <= 0.0:
        return None
    return seconds / calls * 1e3


def roofline(ctx: Mapping[str, Any], match: Callable[[str], bool],
             least_per_launch: Callable[[int], float]) -> float | None:
    """100 × Σ least seconds ÷ Σ device seconds over the kernels whose
    names ``match``; ``least_per_launch(i)`` is launch i's least time.
    None where none ran."""
    ops = ctx['trace'].ops_named(match)
    device = sum(e - s for _, s, e, _ in ops)
    if not ops or device <= 0.0:
        return None
    return 100.0 * sum(least_per_launch(i) for i in range(len(ops))) / device


def mfu(ctx: Mapping[str, Any]) -> float | None:
    """100 × the configuration's FLOPs for the window's units ÷ (the
    traced window's seconds × the bf16 peak)."""
    trace = ctx['trace']
    if not ctx['units'] or trace.window_s <= 0.0:
        return None
    return (100.0 * ctx['flops_per_unit'] * ctx['units']
            / (trace.window_s * BF16_PEAK))


def idle(ctx: Mapping[str, Any]) -> float | None:
    """100 × (1 − device busy ÷ the traced window)."""
    trace = ctx['trace']
    if trace.window_s <= 0.0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
