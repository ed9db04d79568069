"""Diagnostics (counterpart of ``fetode_tpu/diag``): hysteresis sweeps,
plots, metrics logging, profiling and the roofline table.  ``matplotlib``
is imported inside the plotting functions only, never at import."""

from fetode_tpu_torch.diag.hysteresis import (  # noqa: F401
    loop_openness,
    plot_loops,
    sweep_loop,
)
from fetode_tpu_torch.diag.logging import MetricLogger  # noqa: F401
from fetode_tpu_torch.diag.plots import (  # noqa: F401
    plot_forecast,
    plot_losses,
    plot_model_comparison,
    plot_trajectory,
)
from fetode_tpu_torch.diag.profiling import (  # noqa: F401
    annotate,
    sync,
    time_fn,
    trace,
)
