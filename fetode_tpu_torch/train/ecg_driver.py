"""ECG200 trainer (counterpart of ``fetode_tpu/train/ecg_driver.py:
train_ecg_model``).

AdamW (lr 1e-3, weight decay 1e-4), global-norm clip 1.0, cross-entropy,
minibatches of 8 reshuffled every epoch (seed ``run.seed + epoch``),
train and test accuracy after every block of epochs, and the parameters
of the best test accuracy kept.  Device noise is fresh per training
step: the model's ``apply_fn(params, x, generator)`` gets a generator
seeded from (run seed, epoch, step) (``train/loop.py: step_generator``).
Evaluation averages logits over ``eval_noise_draws`` generators that are
seeded the same way at every evaluation (the fixed eval draws); a
noiseless model ignores them.  ``eval_chunk`` evaluates in chunks of
that many rows, padding the last with the last row, in every solver
mode alike.

``train_ecg_population`` trains P (noise_std, seed) members at once
(counterpart of the JAX package's ``train_ecg_population``): each member
is seeded, shuffled, noised and evaluated as ``train_ecg_model`` with
that seed and std, so its curve is that sequential run's; the members'
latent solves share one launch of the member kernels on the card
(``models/ecg.py: kanfet_mlp_node_apply_members``).
``compare_noise_population`` runs the clean-vs-noisy grid through it,
``compare_noise`` the same grid one run at a time.

Checkpoint/resume (``ckpt_dir``, ``ckpt_every``, ``resume``;
``train/checkpoint.py: DurableLoop``): the train state, the best
snapshot and its accuracy are saved after every block that ends on a
multiple of ``ckpt_every`` epochs and after the last; a resumed run
continues the exact curve of an unbroken one, since every epoch's
shuffle, step generators and eval draws are seeded from the run seed and
the epoch alone.  ``aot_cache`` / ``aot_tag`` are accepted and logged:
the port compiles nothing per run.

``mesh_devices`` / ``mesh_model`` train over a mesh of that many ranks
(``parallel.place_params``): every rank computes the whole minibatch
(the latent solves step a batch under one controller), and
``mesh_model`` > 1 shards the weights' output features over 'model'.  A
model whose ``apply_fn`` takes the mesh (``kanfet_mlp_node_apply(mesh=)``)
solves one block of the batch a rank inside.  Rank 0 alone writes
checkpoints.  The population trainer shards the members over the ranks
(each trains P / n members, no collectives in a step) and gathers the
curves and the best parameters; it refuses ``ckpt_dir`` and
``mesh_model > 1`` with ``ValueError``, as the JAX package's does.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from fetode_tpu_torch.data.ecg200 import batch_iterator
from fetode_tpu_torch.parallel import driver_mesh, place_params
from fetode_tpu_torch.parallel.collectives import all_gather_cat
from fetode_tpu_torch.train.checkpoint import aot_cache_note, resume_run
from fetode_tpu_torch.train.loop import (
    PopulationState,
    derived_seed,
    init_state,
    make_minibatch_epoch,
    make_minibatch_epochs_scanner,
    make_population_epochs_scanner,
)
from fetode_tpu_torch.train.optim import make_optimizer
from fetode_tpu_torch.utils.device import resolve_device

# Streams of the seeds derived from run.seed: step noise, eval draws.
_NOISE, _EVAL = 1, 2


@dataclass
class ECGRun:
    epochs: int = 100
    batch_size: int = 8
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    eval_noise_draws: int = 1   # logits averaged over this many draws
    # >0: evaluate accuracy in chunks of this many rows; 0 = the whole
    # split in one call.
    eval_chunk: int = 0
    # Epochs per call of the block scanner; eval and best-tracking happen
    # once per block.
    epochs_per_call: int = 1
    # >0: train over a ('data', 'model') mesh of this many ranks (the
    # population: its members over the ranks); mesh_model > 1 shards the
    # weights' output features over 'model'.
    mesh_devices: int = 0
    mesh_model: int = 1
    # Durable checkpoint/resume (train/checkpoint.py: DurableLoop).
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    # Accepted and logged: the port has no compiled program to cache.
    aot_cache: str = ""
    aot_tag: str = ""
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def _chunked_logits(apply_i: Callable, x: torch.Tensor, n_draws: int,
                    chunk: int) -> torch.Tensor:
    """Logits of ``x`` averaged over ``n_draws`` draws (``apply_i(xc, i)``),
    in ``chunk``-row pieces when ``chunk`` > 0 (the last padded with the
    last row)."""
    def logits_of(xc):
        return torch.stack([apply_i(xc, i) for i in range(n_draws)]).mean(0)

    n = x.shape[0]
    if not chunk or n <= chunk:
        return logits_of(x)
    pad = (-n) % chunk
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return torch.cat([logits_of(xc) for xc in x.split(chunk)])[:n]


def train_ecg_model(init_fn: Callable, apply_fn: Callable, data,
                    run: ECGRun = ECGRun(), log=print):
    """Generic ECG trainer.

    ``init_fn(generator) -> params`` (an ``nn.Module`` on the run's
    device); ``apply_fn(params, x, generator) -> logits``, the generator
    consumed for device noise by a noisy model and ignored otherwise.
    ``data = (x_train, y_train, x_test, y_test)`` numpy arrays.  Returns
    (best params, history) with the history keys of the JAX package:
    ``loss``, ``train_acc``, ``test_acc``, ``wall_seconds``,
    ``best_test_acc``.
    """
    mesh = driver_mesh(run.mesh_devices, run.mesh_model)
    device = resolve_device(run.device)
    x_train, y_train, x_test, y_test = data
    params = init_fn(torch.Generator().manual_seed(run.seed))
    placed = place_params(params, mesh)
    opt = make_optimizer(run.lr, params=placed, kind="adamw",
                         weight_decay=run.weight_decay,
                         grad_clip=run.grad_clip)
    state = init_state(params, opt)
    noise_seed = derived_seed(run.seed, _NOISE)
    eval_seeds = [derived_seed(run.seed, _EVAL, i)
                  for i in range(max(1, run.eval_noise_draws))]

    def loss_fn(p, generator, xb, yb):
        return cross_entropy(apply_fn(p, xb, generator), yb)

    epoch_fn = make_minibatch_epoch(loss_fn, keyed=True)
    block_fn = make_minibatch_epochs_scanner(loss_fn, keyed=True)

    def tensors(x, y):
        return (torch.as_tensor(x, dtype=torch.float32, device=device),
                torch.as_tensor(y, dtype=torch.long, device=device))

    @torch.no_grad()
    def eval_acc(p, x, y):
        def apply_i(xc, i):
            g = torch.Generator(device=device).manual_seed(eval_seeds[i])
            return apply_fn(p, xc, g)
        return float(accuracy(_chunked_logits(apply_i, x, len(eval_seeds),
                                              run.eval_chunk), y))

    train_split, test_split = tensors(x_train, y_train), tensors(x_test,
                                                                 y_test)
    history = {"loss": [], "train_acc": [], "test_acc": []}
    best = (-1.0, copy.deepcopy(state.params))
    aot_cache_note(run.aot_cache, log)
    dl, start_ep, state, best, _ = resume_run(run, state, best, log)
    t0 = time.perf_counter()
    E = max(1, run.epochs_per_call)
    for ep in range(start_ep, run.epochs, E):
        n = min(E, run.epochs - ep)
        shuffles = [batch_iterator(x_train, y_train, run.batch_size,
                                   seed=run.seed + ep + i) for i in range(n)]
        if n == 1:
            state, losses = epoch_fn(state, (noise_seed, ep),
                                     tensors(*shuffles[0]))
        else:
            state, losses = block_fn(state, (noise_seed, ep), tensors(
                np.stack([s[0] for s in shuffles]),
                np.stack([s[1] for s in shuffles])))
        tr_acc = eval_acc(state.params, *train_split)
        te_acc = eval_acc(state.params, *test_split)
        history["loss"].append(float(losses.mean()))
        history["train_acc"].append(tr_acc)
        history["test_acc"].append(te_acc)
        if te_acc > best[0]:
            best = (te_acc, copy.deepcopy(state.params))
        dl.save(ep + n, state=state, best_crit=best[0], best_params=best[1],
                last=ep + n >= run.epochs)
        # Log whenever the block [ep, ep+n) crossed a log_every boundary,
        # labelled with the last epoch the metrics were evaluated after.
        if log is not None and (
                (ep + n - 1) // run.log_every > (ep - 1) // run.log_every
                or ep + n >= run.epochs):
            log(f"epoch {ep + n - 1:3d} | loss {history['loss'][-1]:.4f} | "
                f"train_acc {tr_acc*100:.1f}% | test_acc {te_acc*100:.1f}%")
    history["wall_seconds"] = time.perf_counter() - t0
    history["best_test_acc"] = best[0]
    return best[1], history


def train_ecg_population(init_fn: Callable, apply_fn: Callable, data,
                         run: ECGRun, members, log=print):
    """Train P independent (noise_std, seed) members at once.

    ``init_fn(generator) -> params`` (one member's, the architecture shared
    by all); ``apply_fn(params, x, generators, noise_stds) -> logits``
    for every member at once: ``params`` the members' modules, x (P, B,
    T), member m's device noise from ``generators[m]`` at
    ``noise_stds[m]`` (std 0 adds zeros), logits (P, B, classes).
    ``members``: (noise_std, seed) pairs.  Member m is initialised,
    shuffled (``batch_iterator(seed=seed + epoch)``), noised (step
    generators from (seed, epoch, step)) and evaluated (the fixed eval
    draws of ``train_ecg_model``, ``eval_chunk`` alike) as
    ``train_ecg_model`` with ``run.seed = seed`` and its std, with its own
    AdamW state and global-norm clip: its curve is that sequential run's.

    Returns ``(best_params, histories)``: ``best_params`` maps each
    parameter name to a (P, ...) stack of the members' best-test-accuracy
    parameters; ``histories`` is a list of P dicts shaped like
    ``train_ecg_model``'s history, plus ``block_seconds`` (wall seconds of
    each block's training steps, the first with the kernels' build when
    they are not built yet).

    ``run.mesh_devices`` > 0 shards the members over the ranks: P must
    divide, each rank trains its block of P / n members with no
    collectives in a step (its members' latent solves in one launch of
    the member kernels), and every block's accuracies and losses and the
    best parameters are gathered, so every rank returns all P members.
    """
    if run.ckpt_dir:
        raise ValueError("train_ecg_population does not support "
                         "checkpoint options — use train_ecg_model")
    if run.mesh_model > 1:
        raise ValueError("train_ecg_population shards the POPULATION axis "
                         "over 'data'; mesh_model tensor-sharding is not "
                         "supported here")
    mesh = None
    if run.mesh_devices:
        if len(members) % run.mesh_devices:
            raise ValueError(f"population P={len(members)} not divisible "
                             f"by mesh_devices={run.mesh_devices}")
        mesh = driver_mesh(run.mesh_devices)
        block = len(members) // run.mesh_devices
        lo = mesh.axis_index("data") * block
        members = list(members)[lo:lo + block]

    def gather(t: torch.Tensor) -> torch.Tensor:
        """Every rank's members along axis 0 (all P in member order)."""
        if mesh is None or mesh.size == 1:
            return t
        return all_gather_cat(t, mesh.group("data"))

    aot_cache_note(run.aot_cache, log)
    device = resolve_device(run.device)
    x_train, y_train, x_test, y_test = data
    P = len(members)
    stds = [float(m[0]) for m in members]
    seeds = [int(m[1]) for m in members]
    states = []
    for seed in seeds:
        params = init_fn(torch.Generator().manual_seed(seed))
        states.append(init_state(params, make_optimizer(
            run.lr, params=params.parameters(), kind="adamw",
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)))
    states = PopulationState(tuple(states))
    noise_seeds = [derived_seed(seed, _NOISE) for seed in seeds]
    n_draws = max(1, run.eval_noise_draws)
    eval_seeds = [[derived_seed(seed, _EVAL, i) for i in range(n_draws)]
                  for seed in seeds]

    def loss_fn(ps, gens, std_v, xb, yb):
        logits = apply_fn(ps, xb, gens, std_v)
        return torch.stack([cross_entropy(logits[m], yb[m])
                            for m in range(P)])

    block_fn = make_population_epochs_scanner(loss_fn)

    def tensors(x, y):
        return (torch.as_tensor(x, dtype=torch.float32, device=device),
                torch.as_tensor(y, dtype=torch.long, device=device))

    @torch.no_grad()
    def eval_acc(ps, x, y):
        def apply_i(xc, i):
            gens = [torch.Generator(device=device).manual_seed(s[i])
                    for s in eval_seeds]
            return apply_fn(ps, xc.expand((P,) + tuple(xc.shape)), gens,
                            stds).transpose(0, 1)
        logits = _chunked_logits(apply_i, x, n_draws, run.eval_chunk)
        return [float(accuracy(logits[:, m], y)) for m in range(P)]

    train_split, test_split = tensors(x_train, y_train), tensors(x_test,
                                                                 y_test)
    curves = {"loss": [], "train_acc": [], "test_acc": []}
    best_acc = [-1.0] * P
    best = [copy.deepcopy(p) for p in states.params]
    block_seconds = []
    t0 = time.perf_counter()
    E = max(1, run.epochs_per_call)
    for ep in range(0, run.epochs, E):
        tb0 = time.perf_counter()
        n = min(E, run.epochs - ep)
        shuffles = [[batch_iterator(x_train, y_train, run.batch_size,
                                    seed=seed + ep + i) for i in range(n)]
                    for seed in seeds]
        eb = tensors(np.stack([[b[0] for b in row] for row in shuffles]),
                     np.stack([[b[1] for b in row] for row in shuffles]))
        states, losses = block_fn(states, [(s, ep) for s in noise_seeds],
                                  stds, eb)
        losses = losses.cpu()
        block_seconds.append(time.perf_counter() - tb0)
        tr = eval_acc(states.params, *train_split)
        te = eval_acc(states.params, *test_split)
        for m in range(P):
            if te[m] > best_acc[m]:
                best_acc[m] = te[m]
                best[m] = copy.deepcopy(states.params[m])
        row = gather(torch.tensor(
            [[float(losses[m].mean()), tr[m], te[m]] for m in range(P)],
            dtype=torch.float64, device=device)).tolist()
        curves["loss"].append([r[0] for r in row])
        curves["train_acc"].append([r[1] for r in row])
        te = [r[2] for r in row]
        curves["test_acc"].append(te)
        if log is not None and (
                (ep + n - 1) // run.log_every > (ep - 1) // run.log_every
                or ep + n >= run.epochs):
            log(f"epoch {ep + n - 1:3d} | population P={len(te)} | test_acc "
                f"mean {np.mean(te)*100:.1f}% "
                f"[{np.min(te)*100:.1f}, {np.max(te)*100:.1f}]%")
    wall = time.perf_counter() - t0
    best_acc = gather(torch.tensor(best_acc, dtype=torch.float64,
                                   device=device)).tolist()
    P = len(best_acc)
    histories = [{
        "loss": [row[m] for row in curves["loss"]],
        "train_acc": [row[m] for row in curves["train_acc"]],
        "test_acc": [row[m] for row in curves["test_acc"]],
        "best_test_acc": best_acc[m],
        "wall_seconds": wall,            # shared: one loop trains them all
        "block_seconds": block_seconds,
    } for m in range(P)]
    sds = [b.state_dict() for b in best]
    stacked = {k: gather(torch.stack([sd[k] for sd in sds])) for k in sds[0]}
    return stacked, histories


def _summary(results, log):
    if log is None:
        return
    for std, per_seed in results.items():
        accs = np.asarray([h["best_test_acc"] for h in per_seed.values()])
        log(f"noise_std {std}: best test acc "
            f"{accs.mean()*100:.1f}% +/- {accs.std()*100:.1f}% "
            f"(seeds {list(per_seed)})")


def compare_noise_population(init_fn: Callable, apply_fn: Callable, data,
                             noise_stds=(0.0, 0.2), run: ECGRun = ECGRun(),
                             seeds=(0,), log=print):
    """The noise levels x seeds grid as one population
    (``train_ecg_population``; the reference's 3-seed x 4-noise study,
    ``compare_noise_ecg.py:1250-1452``).  ``apply_fn`` is the population
    form, ``(params, x, generators, noise_stds) -> logits``.  Returns
    ``{std: {seed: history}}``, as ``compare_noise``."""
    members = [(std, seed) for std in noise_stds for seed in seeds]
    _, hists = train_ecg_population(init_fn, apply_fn, data, run, members,
                                    log=log)
    results = {}
    for (std, seed), hist in zip(members, hists):
        results.setdefault(std, {})[seed] = hist
    _summary(results, log)
    return results


def compare_noise(make_model: Callable, data, noise_stds=(0.0, 0.2),
                  run: ECGRun = ECGRun(), seeds=(0,), log=print):
    """The same architecture trained at each device-noise level and seed,
    one ``train_ecg_model`` run after another; ``make_model(std) ->
    (init_fn, apply_fn)``.  Returns ``{std: {seed: history}}``."""
    results = {}
    for std in noise_stds:
        per_seed = {}
        for seed in seeds:
            if log is not None:
                log(f"--- noise_std = {std}, seed = {seed} ---")
            init_fn, apply_fn = make_model(std)
            _, per_seed[seed] = train_ecg_model(
                init_fn, apply_fn, data, dataclasses.replace(run, seed=seed),
                log)
        results[std] = per_seed
    _summary(results, log)
    return results
