"""Library-level predator-prey training loop (the port's counterpart of
``examples/01_predprey_train_loop.py``).

Generate the Lotka-Volterra ground truth, build the KANFET NODE flagship
spec (``max_steps=128``), and take Adam steps (lr 2e-3, no clip, no
schedule, as the JAX example's ``optax.adam``) through the
differentiable dopri5 solve of the fit window.  On the card the solve is
the discrete-adjoint kernel pair (``ops/kanfet_adjoint.py``: the
recording forward and the replay backward); on the CPU the eager scan
solve.

Run:  python -m fetode_tpu_torch.examples.predprey_train_loop [epochs]
      [--device cpu]

The last line is ``done: <final train MSE>``.  Parameters come from a
torch seed, so the curve is not the JAX example's (its init comes from
``PRNGKey(0)``); ``tests/test_torch_predprey_driver.py`` holds the loss
and first gradient at the JAX example's converted init against its
``trajectory_loss``.
"""

from __future__ import annotations

import argparse
import math

import torch

from fetode_tpu_torch.models.predprey import (
    PredPreyNODE,
    PredPreyTask,
    generate_data,
    predprey_init,
    trajectory_loss,
)
from fetode_tpu_torch.train.optim import make_optimizer
from fetode_tpu_torch.utils.device import resolve_device


def problem(device):
    """(spec, x0, the fit window's times, its targets) of the example."""
    task = PredPreyTask()                      # alpha=1.5 beta=1 gamma=3
    spec = PredPreyNODE.kanfet(max_steps=128)  # KANFET [2,10,2], dopri5 1e-7
    _, ts_learn, truth = generate_data(task, device=device)
    target = truth[:task.n_train]              # fit window t in [0, 3.5]
    x0 = torch.tensor([task.x0, task.y0], device=device)
    return spec, x0, ts_learn, target


def train(epochs: int, device: str = "cuda", params=None, log=print):
    """Train for ``epochs`` full-batch Adam steps from ``params`` (default:
    ``predprey_init`` from seed 0); returns (params, losses), losses[i]
    the train MSE before step i's update."""
    dev = resolve_device(device)
    spec, x0, ts_learn, target = problem(dev)
    if params is None:
        params = predprey_init(torch.Generator().manual_seed(0), spec,
                               device=dev)
    opt = make_optimizer(2e-3, params=params.parameters(), kind="adam")
    losses = []
    for epoch in range(epochs):
        opt.zero_grad()
        loss = trajectory_loss(params, spec, x0, ts_learn, target)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log is not None and (epoch % 50 == 0 or epoch == epochs - 1):
            log(f"epoch {epoch:5d}  train MSE {losses[-1]:.6f}")
    return params, losses


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses = train(args.epochs, args.device)
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"non-finite train MSE: {losses}")
    print("done:", losses[-1])
    return losses[-1]


if __name__ == "__main__":
    main()
