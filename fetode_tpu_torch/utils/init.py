"""Weight initialisers (counterpart of ``fetode_tpu/utils/init.py``).

`kaiming_uniform` follows the fan-in leaky-ReLU convention
(``nn.init.kaiming_uniform_`` with ``a = sqrt(5) * scale``): gain =
sqrt(2 / (1 + a^2)), bound = sqrt(3) * gain / sqrt(fan_in).

Draws come from an explicit ``torch.Generator`` on the generator's own
device and are then moved to ``device``, so one seed gives the same
numbers whichever device the parameters end up on.
"""

from __future__ import annotations

import math

import torch


def kaiming_uniform(generator: torch.Generator, shape, a: float = math.sqrt(5),
                    fan_in: int | None = None, *, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    if fan_in is None:
        fan_in = shape[-1] if len(shape) >= 2 else shape[0]
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = math.sqrt(3.0) * gain / math.sqrt(fan_in)
    return uniform(generator, shape, -bound, bound, device=device, dtype=dtype)


def uniform(generator: torch.Generator, shape, lo: float, hi: float, *,
            device=None, dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device,
                   dtype=dtype)
    return (u * (hi - lo) + lo).to(device)


def normal(generator: torch.Generator, shape, *, device=None,
           dtype=torch.float32) -> torch.Tensor:
    z = torch.randn(tuple(shape), generator=generator, device=generator.device,
                    dtype=dtype)
    return z.to(device)
