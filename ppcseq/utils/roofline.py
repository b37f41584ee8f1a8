"""Roofline / utilization accounting for the sampler hot op.

XLA's own HLO cost model supplies flops / bytes-accessed for the compiled
program (`compiled.cost_analysis()`); this module pairs those with the
device's published peaks to give flops/s, HBM bytes/s and the share of each
peak for bench.py and scripts/bench_scale.py.

The hot op is transcendental-heavy elementwise math (exp/log/sigmoid per NB
point) plus a [S, C] @ [C, G] design product with C = 2, so the ceilings
that can bind are the float32 rate outside the tensor cores and HBM
bandwidth; the bf16 tensor-core peak is kept for reference only.
Transcendentals lower to multi-op polynomials, which the XLA flop count
already includes (it counts the expanded HLO ops).
"""

from __future__ import annotations

from typing import Any

# device_kind (jax.Device.device_kind) -> peaks. Source: NVIDIA H100 Tensor
# Core GPU data sheet, SXM5 part, dense rates without sparsity, at the full
# 700 W power limit (a card set lower cannot hold its top clock under load).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_sec": 3.35e12,
        "f32_flops": 67e12,  # FP32 outside the tensor cores
        "bf16_flops": 989e12,  # dense bf16 tensor-core rate
    },
}


def peaks_for(device: Any) -> dict:
    """Peak rates of `device`; a device kind not in PEAKS is an error."""
    kind = getattr(device, "device_kind", str(device))
    if kind not in PEAKS:
        raise KeyError(
            f"no roofline peaks recorded for device kind {kind!r}; "
            f"known: {sorted(PEAKS)}"
        )
    return PEAKS[kind]


def cost_of(fn, *args, **kwargs) -> dict:
    """flops / bytes-accessed of one jitted call, from XLA's HLO cost model.

    Returns {"flops": float | None, "bytes": float | None}; None when the
    backend exposes no cost analysis.
    """
    import jax

    try:
        compiled = jax.jit(fn).lower(*args, **kwargs).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        if ca is None:
            return {"flops": None, "bytes": None}
        return {
            "flops": float(ca.get("flops", 0.0)) or None,
            "bytes": float(ca.get("bytes accessed", 0.0)) or None,
        }
    except Exception:  # cost analysis is best-effort diagnostics
        return {"flops": None, "bytes": None}


def utilization(
    flops_per_sec: float | None,
    bytes_per_sec: float | None,
    device: Any,
) -> dict:
    """Shares of the device's f32 and HBM peaks + a one-line note."""
    peaks = peaks_for(device)
    out: dict[str, Any] = {
        "flops_per_sec": flops_per_sec,
        "hbm_bytes_per_sec": bytes_per_sec,
    }
    notes = []
    if flops_per_sec is not None:
        f32_frac = flops_per_sec / peaks["f32_flops"]
        out["f32_peak_frac"] = f32_frac
        notes.append(
            f"{flops_per_sec / 1e12:.3f} TFLOP/s (XLA HLO count) = "
            f"{100 * f32_frac:.1f}% of the {peaks['f32_flops'] / 1e12:.0f} "
            "TFLOP/s f32 peak"
        )
    if bytes_per_sec is not None:
        hbm_frac = bytes_per_sec / peaks["hbm_bytes_per_sec"]
        out["hbm_peak_frac"] = hbm_frac
        notes.append(
            f"{bytes_per_sec / 1e9:.0f} GB/s = {100 * hbm_frac:.1f}% of the "
            f"{peaks['hbm_bytes_per_sec'] / 1e9:.0f} GB/s HBM peak"
        )
    out["utilization_note"] = "; ".join(notes) or "no cost analysis"
    return out
