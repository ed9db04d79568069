"""Roofline accounting for benchmark rows (counterpart of
``fetode_tpu/diag/roofline.py``).

``roofline_row`` turns a timed row's work per unit and units per second
into achieved rates, their share of the card's peaks, and a bound
(``compute``, ``bandwidth``, or ``latency`` when both shares are under
2%).  The peak table holds the card the port runs on; an unknown device
or the CPU gives ``bound: "unknown ..."`` and absolute rates only.

The JAX package counts a call's work with XLA's cost model; the port
has none, so ``flop_cost`` counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions; elementwise work is not counted) and bytes as the call's
inputs plus its outputs, each once.  Rows record that rule in
``flop_source``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from fetode_tpu_torch.utils.trees import tree_leaves

# Peaks of one NVIDIA H100 SXM5 80GB (its name on the card: "NVIDIA H100
# 80GB HBM3"), keys matched as substrings of the lowercased
# ``torch.cuda.get_device_name``.  FP32 outside the tensor cores and HBM3
# from NVIDIA's H100 data sheet (no TF32: the port keeps full float32
# products wherever an error estimate drives step control); the special
# function unit at 16 results per SM per clock (Hopper architecture
# white paper) on 132 SMs at the 1.98 GHz boost clock.  chip_smoke.py's
# bounds read these figures.
_H100 = {"name": "NVIDIA H100 80GB HBM3", "peak_flops": 67e12,
         "peak_hbm_Bps": 3.35e12, "peak_sfu": 132 * 16 * 1.98e9}
DEVICE_PEAKS = {"h100 80gb hbm3": _H100}

FLOP_SOURCE = "torch FlopCounterMode; bytes = inputs + outputs"

# Below this fraction of BOTH peaks the row is not meaningfully sitting
# on either roofline: serial dependencies and launches dominate.
_LATENCY_FRACTION = 0.02


def device_peaks(device=None) -> Optional[Dict[str, Any]]:
    """The peak table's entry for ``device``: a ``torch.device`` or its
    string (``"cuda:0"``, ``"cpu"``), or a card's name as
    ``torch.cuda.get_device_name`` gives it; default the current CUDA
    device, else the CPU.  None when unknown (the CPU included)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:          # not a device string: a card's name
            return _match(device)
    if device.type != "cuda":
        return None
    return _match(torch.cuda.get_device_name(device))


def _match(kind: str) -> Optional[Dict[str, Any]]:
    kind = kind.lower()
    for key, peaks in DEVICE_PEAKS.items():
        if key in kind:
            return dict(peaks)
    return None


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def flop_cost(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one call ``fn(*args)`` (see the module
    docstring for what each counts)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(_nbytes(args) + _nbytes(out))}


def roofline_row(flops_per_unit: float, bytes_per_unit: float,
                 units_per_sec: float, *, device=None,
                 flop_source: str = FLOP_SOURCE) -> Dict[str, Any]:
    """One roofline record for a bench row; ``units_per_sec`` is the row's
    measured throughput in the unit the counts are per."""
    achieved_flops = flops_per_unit * units_per_sec
    achieved_Bps = bytes_per_unit * units_per_sec
    intensity = (flops_per_unit / bytes_per_unit) if bytes_per_unit else None
    row = {
        "flops_per_unit": flops_per_unit,
        "hbm_bytes_per_unit": bytes_per_unit,
        "achieved_gflops": round(achieved_flops / 1e9, 3),
        "achieved_gbps": round(achieved_Bps / 1e9, 3),
        "arithmetic_intensity_flops_per_byte":
            round(intensity, 3) if intensity is not None else None,
        "flop_source": flop_source,
    }
    peaks = device_peaks(device)
    if peaks is None:
        row["bound"] = "unknown (no peak table for this device)"
        return row
    pf = achieved_flops / peaks["peak_flops"]
    pb = achieved_Bps / peaks["peak_hbm_Bps"]
    ridge = peaks["peak_flops"] / peaks["peak_hbm_Bps"]
    row.update({
        "device": peaks["name"],
        "pct_peak_flops": round(100 * pf, 4),
        "pct_peak_hbm": round(100 * pb, 4),
        "ridge_flops_per_byte": round(ridge, 1),
    })
    if max(pf, pb) < _LATENCY_FRACTION:
        row["bound"] = ("latency (serial/dispatch dominated: "
                        f"<{100 * _LATENCY_FRACTION:.0f}% of both peaks)")
    elif intensity is not None and intensity < ridge:
        row["bound"] = "bandwidth"
    else:
        row["bound"] = "compute"
    return row
