"""fetode_tpu_torch — the PyTorch/CUDA port of ``fetode_tpu``.

Counterpart of ``fetode_tpu/__init__.py``.  The JAX package stays the
reference; this package mirrors its layout (``ops``, ``nn``, ``solvers``,
``models``, ``train``, ``serve``, ``config``, ``cli``) with the same module and
function names, so each piece has an obvious twin.  Every Pallas kernel
of the JAX package becomes a hand-written CUDA kernel for Hopper
(``csrc/``), built on first use by ``ops/_build.py``.

The port imports ``torch`` and never ``jax`` or ``fetode_tpu``.

Everything the JAX package does is ported (its layout plus ``diag``,
``utils`` and ``parallel``); the multi-device options (the mesh flags,
``--mesh``) run one process per rank on ``torch.distributed``
(``parallel/``).  The predator-prey KANFET
serving path (``python -m fetode_tpu_torch.cli serve --source
predprey``) solves with the whole-solve dopri5 kernel
``ops/kanfet_node.py``, its training path (``python -m
fetode_tpu_torch.cli predprey``, ``train/``) with the discrete-adjoint
kernel pair ``ops/kanfet_adjoint.py``.
"""

__version__ = "0.1.0"
