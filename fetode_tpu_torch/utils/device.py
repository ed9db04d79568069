"""Device selection (the port's counterpart of the JAX package's platform
pinning in ``cli.py`` and ``utils/debug.py``).

``resolve_device`` is where the package first touches a device.  It
refuses ``cuda`` without a CUDA device — a run asked for the card never
carries on on the CPU — and turns TF32 off: dopri5's embedded error
estimate drives step control and cannot live with TF32's ~3 decimal
digits (the JAX package's rule of full-f32 dots in every kernel whose
error estimate feeds the controller, ``ops/pallas_node.py:33-39``).
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"device {name!r}: expected 'cuda[:N]' or 'cpu'")
    return device
