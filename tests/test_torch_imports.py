"""The PyTorch port imports torch and never jax or the JAX package, nor
pandas or sklearn (the card's machine has neither; the data layer does
their steps with numpy and scipy), nor matplotlib (imported only inside
the plotting functions) or optax.

Checked in a fresh interpreter, since this test process imports both:
every module of ``fetode_tpu_torch`` is imported and ``sys.modules`` must
then hold neither ``jax`` (nor any ``jax.*``) nor ``fetode_tpu`` (nor any
``fetode_tpu.*``; note that the bare prefix ``fetode_tpu`` also matches
``fetode_tpu_torch``), nor ``pandas``, ``sklearn``, ``matplotlib`` or
``optax``.  The subprocess
runs from the repo root with the root on ``PYTHONPATH``, since the
package is not installed.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import fetode_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fetode_tpu_torch.__path__,
                                               "fetode_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "fetode_tpu", "pandas", "sklearn", "matplotlib",
                      "optax")
             or k.startswith(("jax.", "jaxlib", "fetode_tpu.", "pandas.",
                              "sklearn.", "matplotlib.", "optax.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("fetode_tpu_torch.cli", "fetode_tpu_torch.serve",
                 "fetode_tpu_torch.ops.kanfet_node",
                 "fetode_tpu_torch.models.predprey",
                 "fetode_tpu_torch.ops.node_common",
                 "fetode_tpu_torch.ops.logistic_node",
                 "fetode_tpu_torch.ops.ferro_node",
                 "fetode_tpu_torch.models.ecg",
                 "fetode_tpu_torch.data.ecg200",
                 "fetode_tpu_torch.train.ecg_driver",
                 "fetode_tpu_torch.nn.mlp", "fetode_tpu_torch.nn.diffusion",
                 "fetode_tpu_torch.data.paths",
                 "fetode_tpu_torch.data.timeseries",
                 "fetode_tpu_torch.ops.ode_dyn", "fetode_tpu_torch.ops.ddpm",
                 "fetode_tpu_torch.models.forecasting",
                 "fetode_tpu_torch.train.forecast_driver",
                 "fetode_tpu_torch.data.mnist",
                 "fetode_tpu_torch.models.kuramoto",
                 "fetode_tpu_torch.ops.kuramoto",
                 "fetode_tpu_torch.ops.interp",
                 "fetode_tpu_torch.ops.node_enc",
                 "fetode_tpu_torch.ops.mlp_node",
                 "fetode_tpu_torch.ops.kanfet_wide",
                 "fetode_tpu_torch.models.symbolic",
                 "fetode_tpu_torch.models.cond_diffusion",
                 "fetode_tpu_torch.train.cond_diffusion_driver",
                 "fetode_tpu_torch.ops.ferro_fused",
                 "fetode_tpu_torch.nn.rnn",
                 "fetode_tpu_torch.solvers.fixed",
                 "fetode_tpu_torch.ops.spline",
                 "fetode_tpu_torch.examples.custom_field_kernel",
                 "fetode_tpu_torch.data.batching",
                 "fetode_tpu_torch.data.columns",
                 "fetode_tpu_torch.data.informer",
                 "fetode_tpu_torch.data.masking",
                 "fetode_tpu_torch.data.metrics",
                 "fetode_tpu_torch.data.multimodal",
                 "fetode_tpu_torch.data.timefeatures",
                 "fetode_tpu_torch.solvers.adjoint",
                 "fetode_tpu_torch.solvers.stateful",
                 "fetode_tpu_torch.train.checkpoint",
                 "fetode_tpu_torch.examples.predprey_train_loop",
                 "fetode_tpu_torch.nn.ferro_layers",
                 "fetode_tpu_torch.nn.modules",
                 "fetode_tpu_torch.diag.hysteresis",
                 "fetode_tpu_torch.diag.logging",
                 "fetode_tpu_torch.diag.plots",
                 "fetode_tpu_torch.diag.profiling",
                 "fetode_tpu_torch.diag.roofline",
                 "fetode_tpu_torch.train.tools",
                 "fetode_tpu_torch.utils.debug",
                 "fetode_tpu_torch.utils.trees",
                 "fetode_tpu_torch.examples.serving_bundle",
                 "fetode_tpu_torch.examples.custom_dataset_forecast"):
        assert name in report["modules"]


def test_port_sources_name_no_jax_import():
    for path in (ROOT / "fetode_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                # matplotlib is imported inside the plotting functions
                # only: the probe above checks that no import loads it.
                assert mod not in ("jax", "jaxlib", "fetode_tpu", "pandas",
                                   "sklearn", "optax"), \
                    f"{path.relative_to(ROOT)}: {line.strip()}"
