"""Command-line entry point: ``python -m fetode_tpu_torch.cli <workload>
[--k v]`` (counterpart of ``fetode_tpu/cli.py``).

Same workload names and ``--key value`` overrides as the JAX package's
CLI, so one command line drives either package.  Ported so far:

* ``predprey`` — trains the predprey KANFET NODE on one trajectory
  (``train/predprey_driver.py``) and reports epochs/s and the final
  training loss.
* ``ecg`` — trains an ECG200 classifier, ``--model kanfet_node`` (the
  default; its latent field ``--field plain`` or ``mlp``),
  ``kanfet_mlp_node``, ``fepa_rnn``, ``digital_rnn`` or ``node_rnn``
  (``train/ecg_driver.py``), on the ECG200 files when
  ``$FETODE_DATA_DIR`` holds them, else on the synthetic stand-in, and
  reports the best test accuracy; ``--model all`` trains the JAX CLI's
  comparison set (``digital_rnn``, ``fepa_rnn``, ``kanfet_node``,
  ``kanfet_mlp_node`` clean and noisy) and writes
  ``accuracy_table.json``; ``--model noise_study`` trains the
  ``--noise_stds`` x ``--noise_seeds`` grid of the ferro model as one
  population and writes ``noise_study.json``.
* ``ett`` — trains a forecaster, ``--model point`` (the default),
  ``diffusion``, ``kan_diffusion`` or ``kan_fet_diffusion`` (the KAN-RNN
  context encoder; ``train/forecast_driver.py``), on the ETT CSV when
  ``$FETODE_DATA_DIR`` holds it, else on the synthetic stand-in, and
  reports the test MSE and the wall seconds.
* ``cond_diffusion`` — trains a conditional-diffusion forecaster, one of
  the five denoisers (``--denoiser``, default ``kan_fet_all_node``;
  ``train/cond_diffusion_driver.py``), on the ETT CSV when
  ``$FETODE_DATA_DIR`` holds it, else on the synthetic stand-in, and
  reports the last validation loss and the test MSE / MAE of the sample
  mean.
* ``timemmd`` — trains the diffusion forecaster with the KAN-RNN context
  encoder on a Time-MMD domain's CSV when ``$FETODE_DATA_DIR`` holds it,
  else on the synthetic stand-in; ``--multimodal true`` appends the
  TF-IDF + SVD embedding of the report texts (``data/multimodal.py``;
  synthetic texts on the stand-in), and reports the test MSE.
* ``mnist`` — trains the Kuramoto-lattice KAN classifier
  (``models/kuramoto.py``) on the MNIST idx files when they are found,
  else on synthetic digits, and reports the test accuracy.
* ``symbolic`` — fits the two-layer ferro KAN of ``models/symbolic.py`` to
  y = sin x + 0.1 x^2, saves ``symbolic_trained.npz`` with the JAX CLI's
  keys and reports the first and last loss.
* ``serve --source ecg`` (the default source), ``predprey``, ``ett``,
  ``ddpm``, ``cond_diffusion`` and ``mnist`` — builds the model, exports
  a serving bundle, loads it back and reports p50/p99 latency per batch
  bucket.  ``--ckpt_dir`` serves a training checkpoint's best
  parameters (``train/checkpoint.py``; else its train state's) in place
  of the fresh ones.

The training workloads take ``--ckpt_dir D --ckpt_every N [--resume
true]`` (durable checkpoint/resume) and ``--aot_cache``, which the port
accepts and logs; ``predprey`` also takes ``--shooting_points``.
``--plots`` saves the JAX CLI's plots under ``--out-dir`` (it needs
matplotlib): ``predprey`` the trajectory and the losses, ``ecg`` the
losses and the trained ferro layers' P-E loops (``--model all`` also the
model comparison), ``ett`` the forecast and the losses, ``symbolic``
the loops and the losses; ``timemmd``, ``cond_diffusion``, ``mnist``
and ``serve`` accept the flag and draw nothing, as the JAX CLI does.

``--device cuda`` (the default) without CUDA raises; nothing falls back
to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import tempfile
import time

import torch

WORKLOADS = ("predprey", "ecg", "ett", "cond_diffusion", "timemmd", "mnist",
             "symbolic", "serve")


def _parse(argv):
    p = argparse.ArgumentParser(prog="fetode_tpu_torch", description=__doc__)
    from fetode_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"fetode-tpu-torch {__version__}")
    p.add_argument("workload", choices=WORKLOADS)
    p.add_argument("--out-dir", default="runs/latest")
    p.add_argument("--plots", action="store_true", help="save plot artifacts")
    p.add_argument("--mesh", default=None,
                   help="train over a ('data','model') mesh of ranks: "
                        "'data=N[,model=M]', a rank count, or 'auto' (the "
                        "world, else every card; pure DP). Run alone, the "
                        "CLI starts the ranks itself; under torchrun it "
                        "uses its group. Supported by the ecg / ett / "
                        "cond_diffusion / timemmd / mnist workloads "
                        "(predprey uses --shooting_devices)")
    args, unknown = p.parse_known_args(argv)
    overrides = {}
    key = None
    for tok in unknown:
        if tok.startswith("--"):
            if key is not None:          # previous flag had no value: boolean
                overrides[key] = "true"
            key = tok[2:].replace("-", "_")
        elif key is not None:
            overrides[key] = tok
            key = None
        else:
            p.error(f"unexpected argument {tok!r}")
    if key is not None:                  # trailing valueless flag
        overrides[key] = "true"
    return args, overrides


def run_predprey(cfg, out_dir, plots):
    """Train the predprey KANFET NODE on the reference's trajectory; the
    losses go to ``metrics.jsonl``."""
    from fetode_tpu_torch.diag.logging import MetricLogger
    from fetode_tpu_torch.models.predprey import PredPreyNODE
    from fetode_tpu_torch.train.predprey_driver import (
        PredPreyRun,
        train_predprey,
    )

    spec = PredPreyNODE.kanfet(layers_hidden=cfg.layers,
                               grid_size=cfg.grid_size,
                               ferro_num_basis=cfg.ferro_num_basis,
                               method=cfg.method, rtol=cfg.rtol,
                               atol=cfg.atol, max_steps=cfg.max_steps,
                               solver_mode=cfg.solver_mode)
    run = PredPreyRun(spec=spec, lr=cfg.lr, epochs=cfg.epochs,
                      epochs_per_call=cfg.epochs_per_call, seed=cfg.seed,
                      consistent_time_base=cfg.consistent_time_base,
                      shooting_points=cfg.shooting_points,
                      shooting_devices=cfg.shooting_devices,
                      ckpt_dir=cfg.ckpt_dir, ckpt_every=cfg.ckpt_every,
                      resume=cfg.resume, aot_cache=cfg.aot_cache,
                      device=cfg.device)
    logger = MetricLogger(os.path.join(out_dir, "metrics.jsonl"))
    params, hist = train_predprey(run, log=lambda m: print(m, flush=True))
    for i, (ep, tr) in enumerate(zip(hist["epoch"], hist["train"])):
        logger.log(ep, train=tr, test=hist["test"][i] if hist["test"] else None)
    if plots:
        _predprey_plots(params, spec, hist, out_dir, cfg.device)
    return {"epochs_per_sec": hist["epochs_per_sec"],
            "final_train": hist["train"][-1]}


def _predprey_plots(params, spec, hist, out_dir, device):
    """The JAX CLI's ``trajectory.png`` (the trained NODE from the task's
    x0 over the 140 test times, with four times the attempt budget, by
    ``predict`` on the run's device: B.1 on the card) and ``loss.png``."""
    from fetode_tpu_torch.diag.plots import plot_losses, plot_trajectory
    from fetode_tpu_torch.models.predprey import (
        PredPreyTask,
        generate_data,
        predict,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    task = PredPreyTask()
    ts, _, truth = generate_data(task, device=device)
    mode = spec.solver_mode if spec.solver_mode in ("auto", "pallas") \
        else "while"
    with torch.no_grad():
        pred = predict(params, spec._replace(solver_mode=mode,
                                             max_steps=4 * spec.max_steps),
                       torch.tensor([task.x0, task.y0], device=device), ts)
    plot_trajectory(ts, truth, pred, os.path.join(out_dir, "trajectory.png"),
                    train_cut=task.tf_learn)
    plot_losses({"train": hist["train"], "test": hist["test"]},
                os.path.join(out_dir, "loss.png"))


# ``ecg --model all``: the JAX CLI's comparison set, then kanfet_mlp_node
# with device noise (the --noise_std given, else 0.2).
_ECG_ALL_MODELS = ("digital_rnn", "fepa_rnn", "kanfet_node",
                   "kanfet_mlp_node")


def _ecg_data():
    from fetode_tpu_torch.data.ecg200 import load_ecg200, synthetic_ecg200

    try:
        return load_ecg200()
    except FileNotFoundError:
        print("ECG200 files not found; using synthetic stand-in")
        return synthetic_ecg200()


def _ecg_model(cfg, T, device):
    """``(init_fn, apply_fn, loops_fn)`` of ``cfg.model``: the first two
    as the trainer takes them, ``loops_fn(params)`` the ferro layers whose
    P-E loops ``--plots`` draws, ``[(prefix, layer params, FerroConfig)]``
    (the JAX CLI's lists; none for the models without ferro layers)."""
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.nn import rnn as R

    noisy = cfg.noise_std > 0

    def gen(g):
        return g if noisy else None

    if cfg.model == "kanfet_node":
        spec = M.KanFetNODESpec(T=T, latent_dim=cfg.latent_dim,
                                num_basis=cfg.num_basis, solver=cfg.solver,
                                rtol=cfg.rtol, atol=cfg.atol, field=cfg.field,
                                solver_mode=cfg.solver_mode)
        return (lambda g: M.kanfet_node_init(g, spec, device=device),
                lambda p, x, g: M.kanfet_node_apply(p, spec, x),
                lambda p: [])
    if cfg.model == "kanfet_mlp_node":
        spec = M.KanFetMLPNODESpec(T=T, latent_dim=cfg.latent_dim,
                                   num_basis=cfg.num_basis, solver=cfg.solver,
                                   rtol=cfg.rtol, atol=cfg.atol,
                                   noise_std=cfg.noise_std,
                                   solver_mode=cfg.solver_mode,
                                   gate_impl=cfg.gate_impl)
        # Under --mesh the whole-solve kernel runs one block of the batch a
        # rank (ferro_node_solve_sharded), as the JAX CLI passes its mesh
        # to the pallas path; the other modes run the whole batch.
        mesh = None
        if cfg.mesh_devices and cfg.solver_mode == "pallas":
            from fetode_tpu_torch.parallel import driver_mesh
            mesh = driver_mesh(cfg.mesh_devices, cfg.mesh_model)
        return (lambda g: M.kanfet_mlp_node_init(g, spec, device=device),
                lambda p, x, g: M.kanfet_mlp_node_apply(
                    p, spec, x, generator=gen(g), mesh=mesh),
                lambda p: [("fc1", p.fc1, spec.fc1_cfg),
                           ("fc2", p.fc2, spec.fc2_cfg)])
    if cfg.model == "fepa_rnn":
        rcfg = R.FerroKANRNNConfig(hidden_size=cfg.latent_dim,
                                   num_basis=cfg.num_basis,
                                   noise_std=cfg.noise_std)
        return (lambda g: R.ferro_kan_rnn_init(g, rcfg, device=device),
                lambda p, x, g: R.ferro_kan_rnn_apply(p, rcfg, x,
                                                      generator=gen(g)),
                lambda p: [("cell_input", p.cell.input_basis,
                            rcfg.cell.input_cfg),
                           ("cell_hidden", p.cell.hidden_basis,
                            rcfg.cell.hidden_cfg),
                           ("head", p.head_basis, rcfg.head_cfg)])
    if cfg.model == "digital_rnn":
        dcfg = R.DigitalRNNConfig(hidden_size=cfg.latent_dim)
        return (lambda g: R.digital_rnn_init(g, dcfg, device=device),
                lambda p, x, g: R.digital_rnn_apply(p, dcfg, x),
                lambda p: [])
    if cfg.model == "node_rnn":
        spec = M.NodeRNNSpec(hidden_size=cfg.latent_dim,
                             num_basis=cfg.num_basis, noise_std=cfg.noise_std)
        return (lambda g: M.node_rnn_init(g, spec, device=device),
                lambda p, x, g: M.node_rnn_apply(p, spec, x,
                                                 generator=gen(g)),
                lambda p: [("basis", p.basis, spec.basis_cfg),
                           ("cell_input", p.cell.input_basis,
                            spec.cell_cfg.input_cfg),
                           ("cell_hidden", p.cell.hidden_basis,
                            spec.cell_cfg.hidden_cfg)])
    raise SystemExit(f"unknown ECG model {cfg.model!r}")


def _run_ecg_all(cfg, data, out_dir, plots):
    """The JAX CLI's ``ecg --model all``: each variant in its own
    sub-directory, the best test accuracies in ``accuracy_table.json``
    and, with ``plots``, each variant's plots and the test-accuracy curves
    in ``model_comparison.png``; returns the accuracies and each variant's
    loss curve."""
    import dataclasses

    variants = [(m, 0.0) for m in _ECG_ALL_MODELS]
    variants.append(("kanfet_mlp_node",
                     cfg.noise_std if cfg.noise_std > 0 else 0.2))
    table, curves, acc_curves = {}, {}, {}
    for name, noise in variants:
        label = f"{name}_noisy" if noise > 0 else name
        sub = os.path.join(out_dir, label)
        os.makedirs(sub, exist_ok=True)
        print(f"[ecg all] training {label}", flush=True)
        res = run_ecg(dataclasses.replace(cfg, model=name, noise_std=noise),
                      sub, plots, data=data)
        table[label] = res["best_test_acc"]
        curves[label] = res["loss_curve"]
        acc_curves[label] = res["test_acc_curve"]
        print(f"[ecg all] {label}: best test acc {res['best_test_acc']:.4f}",
              flush=True)
    if plots:
        from fetode_tpu_torch.diag.plots import plot_model_comparison

        plot_model_comparison(acc_curves,
                              os.path.join(out_dir, "model_comparison.png"))
    with open(os.path.join(out_dir, "accuracy_table.json"), "w") as f:
        json.dump(table, f, indent=2)
    print("model".ljust(26), "best test acc")
    for label, acc in sorted(table.items(), key=lambda kv: -kv[1]):
        print(label.ljust(26), f"{acc:.4f}")
    return {"best_test_acc": table, "loss_curves": curves}


def _run_ecg_noise_study(cfg, data, out_dir, device):
    """The reference's clean-vs-noisy device study
    (``compare_noise_ecg.py:1250-1452``) as one population: every
    (noise_std, seed) member of ``--noise_stds`` x ``--noise_seeds`` trains
    as a member of ``train/ecg_driver.py: compare_noise_population``, the
    ferro ``KanFetMLPNODE`` at the CLI's widths with each member's noise
    std its own.  On the card (``--solver_mode pallas``, or ``auto``) the
    members' latent solves are one launch of the member kernels
    (``ops/ferro_node.py: ferro_node_solve_members``); on the CPU each
    member's eager solve runs in turn.  ``scan`` runs as ``auto``, as in
    the JAX CLI.  Writes ``noise_study.json``: per std the mean best test
    accuracy and each seed's.

    Unlike the JAX CLI, which sets it in pallas mode only
    (``fetode_tpu/cli.py:294``), the accuracy evals run in chunks of
    ``eval_chunk = 2 * batch_size`` rows in every solver mode, so both
    modes draw the same eval noise and evaluate the same function."""
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.train.ecg_driver import (
        ECGRun,
        compare_noise_population,
    )

    T = data[0].shape[1]
    stds = tuple(float(s) for s in str(cfg.noise_stds).split(",") if s)
    seeds = tuple(int(s) for s in str(cfg.noise_seeds).split(",") if s)
    solver_mode = cfg.solver_mode if cfg.solver_mode != "scan" else "auto"
    if cfg.solver_mode == "scan":
        print("[noise_study] --solver-mode scan runs as 'auto' here "
              "(no-grad eval passes through a checkpointed scan compile "
              "pathologically)", flush=True)
    if cfg.mesh_model > 1:
        raise SystemExit("[noise_study] --mesh model>1 is not supported: "
                         "the study shards the POPULATION axis over "
                         "'data' (train/ecg_driver.py)")
    spec = M.KanFetMLPNODESpec(T=T, latent_dim=cfg.latent_dim,
                               num_basis=cfg.num_basis, solver=cfg.solver,
                               rtol=cfg.rtol, atol=cfg.atol,
                               solver_mode=solver_mode)
    run = ECGRun(epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
                 weight_decay=cfg.weight_decay, seed=cfg.seed,
                 epochs_per_call=max(1, cfg.epochs_per_call),
                 eval_noise_draws=4, aot_cache=cfg.aot_cache,
                 mesh_devices=cfg.mesh_devices,
                 eval_chunk=2 * cfg.batch_size, device=cfg.device)
    results = compare_noise_population(
        lambda g: M.kanfet_mlp_node_init(g, spec, device=device),
        lambda ps, x, gens, std_v: M.kanfet_mlp_node_apply_members(
            ps, spec, x, generators=gens, noise_stds=std_v),
        data, noise_stds=stds, run=run, seeds=seeds,
        log=lambda m: print(m, flush=True))
    summary = {
        str(std): {
            "mean_best_test_acc": float(
                sum(h["best_test_acc"] for h in per_seed.values())
                / len(per_seed)),
            "per_seed": {str(s): float(h["best_test_acc"])
                         for s, h in per_seed.items()},
        }
        for std, per_seed in results.items()
    }
    with open(os.path.join(out_dir, "noise_study.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    hists = {f"{std}/{seed}": h for std, per_seed in results.items()
             for seed, h in per_seed.items()}
    return {"noise_study": summary,
            "loss_curves": {k: [float(v) for v in h["loss"]]
                            for k, h in hists.items()},
            "block_seconds": next(iter(hists.values()))["block_seconds"],
            "eval_chunk": run.eval_chunk}


def run_ecg(cfg, out_dir, plots, data=None):
    """Train an ECG200 classifier (``cfg.model``; ``all``, the comparison
    set), on the ECG200 files when they are found, else on the synthetic
    stand-in."""
    from fetode_tpu_torch.train.ecg_driver import ECGRun, train_ecg_model
    from fetode_tpu_torch.utils.device import resolve_device

    if cfg.gate_impl != "sigmoid" and cfg.model != "kanfet_mlp_node":
        raise SystemExit(
            f"--gate-impl {cfg.gate_impl!r} is only supported by "
            f"--model kanfet_mlp_node (model {cfg.model!r} has no "
            f"gate_impl field)")
    device = resolve_device(cfg.device)
    if data is None:
        data = _ecg_data()
    if cfg.model == "all":
        return _run_ecg_all(cfg, data, out_dir, plots)
    if cfg.model == "noise_study":
        return _run_ecg_noise_study(cfg, data, out_dir, device)
    init_fn, apply_fn, loops_fn = _ecg_model(cfg, data[0].shape[1], device)
    run = ECGRun(epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
                 weight_decay=cfg.weight_decay, seed=cfg.seed,
                 epochs_per_call=cfg.epochs_per_call,
                 mesh_devices=cfg.mesh_devices, mesh_model=cfg.mesh_model,
                 ckpt_dir=cfg.ckpt_dir, ckpt_every=cfg.ckpt_every,
                 resume=cfg.resume, aot_cache=cfg.aot_cache,
                 device=cfg.device)
    params, hist = train_ecg_model(init_fn, apply_fn, data, run,
                                   log=lambda m: print(m, flush=True))
    if plots:
        _ecg_plots(cfg, loops_fn(params), hist, out_dir)
    return {"best_test_acc": hist["best_test_acc"],
            "test_acc_curve": [float(a) for a in hist["test_acc"]],
            "loss_curve": [float(v) for v in hist["loss"]],
            "wall_seconds": hist["wall_seconds"]}


def _ecg_plots(cfg, layers, hist, out_dir):
    """The JAX CLI's ECG plots: ``loss.png`` and, for each trained ferro
    layer, its P-E loops under ``hysteresis/`` (6 panels a layer), and with
    ``noise_std > 0`` the noisy panels too, drawn from a generator of
    their own for each layer, seeded from (seed, layer index) as the JAX
    CLI folds the layer index into its key."""
    import numpy as np

    from fetode_tpu_torch.diag.hysteresis import plot_loops
    from fetode_tpu_torch.diag.plots import plot_losses

    plot_losses({"loss": hist["loss"]}, os.path.join(out_dir, "loss.png"),
                logy=False)
    loops = os.path.join(out_dir, "hysteresis")
    for li, (prefix, params, fcfg) in enumerate(layers):
        plot_loops(params, fcfg, loops, max_panels=6, prefix=prefix)
        if cfg.noise_std > 0:
            seed = int(np.random.SeedSequence([cfg.seed, li])
                       .generate_state(1)[0])
            plot_loops(params, fcfg, loops, max_panels=6,
                       prefix=f"{prefix}_noisy",
                       generator=torch.Generator(params.k.device)
                       .manual_seed(seed))


# The context encoder of each diffusion model.
_ETT_ENCODERS = {"diffusion": "mlp", "kan_diffusion": "kan",
                 "kan_fet_diffusion": "kanrnn"}


def run_ett(cfg, out_dir, plots):
    """Train an ETT forecaster: ``point``, ``diffusion``,
    ``kan_diffusion`` or ``kan_fet_diffusion``, on the ETT CSV when it is
    found, else on the synthetic stand-in."""
    from fetode_tpu_torch.data.timeseries import load_ett_csv, synthetic_series
    from fetode_tpu_torch.models.forecasting import (
        DiffusionForecasterSpec,
        LatentODEForecasterSpec,
    )
    from fetode_tpu_torch.train.forecast_driver import (
        ForecastRun,
        train_diffusion_forecaster,
        train_point_forecaster,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    if cfg.model != "point" and cfg.model not in _ETT_ENCODERS:
        raise SystemExit(f"unknown ETT model {cfg.model!r}")
    resolve_device(cfg.device)
    try:
        X, y, _ = load_ett_csv(name=cfg.dataset, target_col=cfg.target)
    except FileNotFoundError:
        print("ETT csv not found; using synthetic stand-in")
        X, y = synthetic_series(n=2000, n_features=6)
    run = ForecastRun(context_len=cfg.context_len, pred_len=cfg.pred_len,
                      batch_size=cfg.batch_size, epochs=cfg.epochs,
                      lr=cfg.lr, weight_decay=cfg.weight_decay,
                      eval_samples=cfg.eval_samples, seed=cfg.seed,
                      mesh_devices=cfg.mesh_devices,
                      mesh_model=cfg.mesh_model, ckpt_dir=cfg.ckpt_dir,
                      ckpt_every=cfg.ckpt_every, resume=cfg.resume,
                      aot_cache=cfg.aot_cache, device=cfg.device)
    common = dict(num_features=X.shape[1], context_len=cfg.context_len,
                  pred_len=cfg.pred_len, latent_dim=cfg.latent_dim,
                  solver_mode=cfg.solver_mode)
    log = lambda m: print(m, flush=True)  # noqa: E731
    if cfg.model == "point":
        spec = LatentODEForecasterSpec(**common)
        _, hist = train_point_forecaster(spec, X, y, run, log=log)
    else:
        spec = DiffusionForecasterSpec(diff_T=cfg.diff_t,
                                       encoder=_ETT_ENCODERS[cfg.model],
                                       **common)
        _, hist = train_diffusion_forecaster(spec, X, y, run, log=log)
    if plots:
        from fetode_tpu_torch.diag.plots import plot_forecast, plot_losses

        plot_losses({"train": hist["train"], "val": hist["val"]},
                    os.path.join(out_dir, "loss.png"))
        plot_forecast(y, hist["final_forecast"],
                      os.path.join(out_dir, "forecast.png"))
    return {"test_mse": hist["test_mse"],
            "wall_seconds": hist["wall_seconds"],
            "train_curve": hist["train"], "val_curve": hist["val"]}


def timemmd_data(cfg):
    """The Time-MMD series ``cli timemmd`` trains on: (X (N, F), y (N,)),
    the domain's CSV when it is found, else the synthetic stand-in;
    ``cfg.multimodal`` appends the report texts' embedding."""
    from fetode_tpu_torch.data.multimodal import fuse_features
    from fetode_tpu_torch.data.paths import locate
    from fetode_tpu_torch.data.timeseries import (
        load_timemmd_csv,
        synthetic_series,
    )

    fuse = dict(embed_dim=cfg.text_embed_dim,
                max_features=cfg.tfidf_max_features)
    csv = locate(f"../Time_MMD/numerical/{cfg.domain}/{cfg.domain}.csv") or \
        locate(f"Time_MMD/numerical/{cfg.domain}/{cfg.domain}.csv")
    if csv:
        X, y, df = load_timemmd_csv(csv, target_col="OT")
        if cfg.multimodal and "text" in df:
            X, _ = fuse_features(X, list(df["text"]), int(len(X) * 0.7),
                                 **fuse)
    else:
        print(f"Time-MMD {cfg.domain} csv not found; using synthetic stand-in")
        # n=1200 keeps every chronological split (10% val) longer than
        # the preset's context_len + pred_len window (50 + 12).
        X, y = synthetic_series(n=1200, n_features=4)
        if cfg.multimodal:
            # Synthetic report texts, the JAX CLI's, so that the fusion
            # runs end to end without the dataset.
            texts = [f"report level {int(v * 7) % 11} trend "
                     f"{'up' if i % 3 else 'down'}" for i, v in enumerate(y)]
            X, _ = fuse_features(X, texts, int(len(X) * 0.7), **fuse)
    return X, y


def run_timemmd(cfg, out_dir, plots):
    """Train the Time-MMD diffusion forecaster (the KAN-RNN context
    encoder) on ``timemmd_data``; ``plots`` draws nothing, as in the JAX
    CLI."""
    from fetode_tpu_torch.models.forecasting import DiffusionForecasterSpec
    from fetode_tpu_torch.train import forecast_driver
    from fetode_tpu_torch.utils.device import resolve_device

    resolve_device(cfg.device)
    X, y = timemmd_data(cfg)
    run = forecast_driver.ForecastRun(
        context_len=cfg.context_len, pred_len=cfg.pred_len,
        batch_size=cfg.batch_size, epochs=cfg.epochs, lr=cfg.lr,
        seed=cfg.seed, mesh_devices=cfg.mesh_devices,
        mesh_model=cfg.mesh_model, ckpt_dir=cfg.ckpt_dir,
        ckpt_every=cfg.ckpt_every, resume=cfg.resume,
        aot_cache=cfg.aot_cache, device=cfg.device)
    spec = DiffusionForecasterSpec(num_features=X.shape[1],
                                   context_len=cfg.context_len,
                                   pred_len=cfg.pred_len, encoder="kanrnn")
    _, hist = forecast_driver.train_diffusion_forecaster(
        spec, X, y, run, log=lambda m: print(m, flush=True))
    return {"test_mse": hist["test_mse"],
            "wall_seconds": hist["wall_seconds"],
            "train_curve": hist["train"], "val_curve": hist["val"]}


def run_cond_diffusion(cfg, out_dir, plots):
    """Train a conditional-diffusion forecaster on the ETT CSV when it is
    found, else on the synthetic stand-in; the test forecast MSE / MAE of
    the sample mean over the first (at most) 256 test windows; ``plots``
    draws nothing, as in the JAX CLI."""
    import numpy as np

    from fetode_tpu_torch.data.timeseries import (
        load_ett_csv,
        make_windows,
        split_time_series,
        standardize_fit,
        synthetic_series,
        window_gather,
    )
    from fetode_tpu_torch.models.cond_diffusion import make_denoiser_spec
    from fetode_tpu_torch.train.cond_diffusion_driver import (
        CondDiffusionRun,
        evaluate_forecast,
        train_conditional_diffusion,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.device)
    try:
        X, _, _ = load_ett_csv(name=cfg.dataset)
    except FileNotFoundError:
        print("ETT csv not found; using synthetic stand-in")
        X, _ = synthetic_series(n=1500, n_features=6)
    tr, va, te = split_time_series(len(X))
    Xs = standardize_fit(X[tr]).apply(X)
    data = {}
    for name, sl in (("train", tr), ("val", va), ("test", te)):
        past, _ = make_windows(Xs[sl], Xs[sl][:, -1], cfg.seq_len,
                               cfg.pred_len)
        starts = np.arange(len(past), dtype=np.int64) + cfg.seq_len
        data[name] = (past, window_gather(Xs[sl], starts, cfg.pred_len))
    spec = make_denoiser_spec(cfg.denoiser, d_in=Xs.shape[1],
                              pred_len=cfg.pred_len, seq_len=cfg.seq_len,
                              solver_mode=cfg.solver_mode)
    run = CondDiffusionRun(seq_len=cfg.seq_len, pred_len=cfg.pred_len,
                           diff_T=cfg.diff_t, epochs=cfg.epochs,
                           batch_size=cfg.batch_size, lr=cfg.lr,
                           eval_samples=cfg.eval_samples, seed=cfg.seed,
                           mesh_devices=cfg.mesh_devices,
                           mesh_model=cfg.mesh_model, ckpt_dir=cfg.ckpt_dir,
                           ckpt_every=cfg.ckpt_every, resume=cfg.resume,
                           aot_cache=cfg.aot_cache, device=cfg.device)
    params, hist = train_conditional_diffusion(
        spec, data, run, log=lambda m: print(m, flush=True))
    past_te, fut_te = data["test"]
    n_eval = min(len(past_te), 256)
    ev = evaluate_forecast(params, spec, run, past_te[:n_eval],
                           fut_te[:n_eval],
                           torch.Generator(device=device).manual_seed(
                               cfg.seed + 1))
    return {"final_val": hist["val"][-1], "test_mse": ev["mse"],
            "test_mae": ev["mae"], "train_curve": hist["train"],
            "val_curve": hist["val"], "wall_seconds": hist["wall_seconds"]}


def _mnist_data():
    """Train and test (images, labels): the MNIST train and t10k files,
    else an 80/20 split of t10k, else synthetic digits (512 / 128), as
    the JAX CLI falls back."""
    from fetode_tpu_torch.data.mnist import load_mnist, synthetic_digits

    try:
        return load_mnist("train"), load_mnist("test")
    except FileNotFoundError:
        pass
    try:
        x_all, y_all = load_mnist("test")
    except FileNotFoundError:
        print("MNIST files not found; using synthetic digits")
        return synthetic_digits(n=512), synthetic_digits(seed=1, n=128)
    n_tr = int(0.8 * len(x_all))
    print(f"MNIST train images not found; using a {n_tr}/"
          f"{len(x_all) - n_tr} split of the real t10k set")
    return (x_all[:n_tr], y_all[:n_tr]), (x_all[n_tr:], y_all[n_tr:])


def run_mnist(cfg, out_dir, plots):
    """Train the Kuramoto-lattice KAN classifier: AdamW, cross-entropy,
    minibatches in a seeded order; the test accuracy after each epoch.
    ``plots`` draws nothing, as in the JAX CLI.  Under a mesh each image is
    its own rollout, so each rank trains on its block of every minibatch
    and the train step sums the gradients (``train/loop.py``);
    ``mesh_model`` > 1 shards the weights' output features over
    'model'."""
    import numpy as np
    import torch.nn.functional as F

    from fetode_tpu_torch.models.kuramoto import (
        KuramotoSpec,
        kuramoto_init,
        kuramoto_kan_apply,
    )
    from fetode_tpu_torch.parallel import (
        driver_mesh,
        place_params,
        shard_rows,
    )
    from fetode_tpu_torch.train.loop import init_state, make_minibatch_epoch
    from fetode_tpu_torch.train.optim import make_optimizer
    from fetode_tpu_torch.utils.device import resolve_device

    mesh = driver_mesh(cfg.mesh_devices, cfg.mesh_model)
    device = resolve_device(cfg.device)
    (x_train, y_train), (x_test, y_test) = _mnist_data()
    spec = KuramotoSpec(H=x_train.shape[1], W=x_train.shape[2],
                        steps=cfg.kuramoto_steps, dt=cfg.dt,
                        num_basis=cfg.num_basis, rollout=cfg.rollout)
    params = kuramoto_init(torch.Generator().manual_seed(cfg.seed), spec,
                           device=device)
    state = init_state(params, make_optimizer(
        cfg.lr, params=place_params(params, mesh, grad_sum=True),
        kind="adamw", weight_decay=1e-4))

    def loss_fn(p, x, y):
        return F.cross_entropy(kuramoto_kan_apply(p, spec, x), y)

    epoch_fn = make_minibatch_epoch(loss_fn)
    xt = torch.from_numpy(x_test).to(device)
    yt = torch.from_numpy(y_test).long().to(device)

    def eval_acc(p):
        with torch.no_grad():
            logits = kuramoto_kan_apply(p, spec, xt)
        return float((logits.argmax(-1) == yt).float().mean())

    bs = min(cfg.batch_size, len(x_train))
    acc = None
    for ep in range(cfg.epochs):
        rng = np.random.default_rng(cfg.seed + ep)
        idx = rng.permutation(len(x_train))[: (len(x_train) // bs) * bs]
        bx = torch.from_numpy(x_train[idx].reshape(-1, bs, *x_train.shape[1:]))
        by = torch.from_numpy(y_train[idx].reshape(-1, bs)).long()
        batches = (bx.to(device), by.to(device))
        if mesh is not None:
            batches = shard_rows(batches, mesh, batch_axis=1)
        state, losses = epoch_fn(state, batches)
        acc = eval_acc(state.params)
        print(f"epoch {ep}: loss {float(losses.mean()):.4f} test acc "
              f"{acc:.4f}", flush=True)
    if acc is None:  # epochs == 0: report the untrained accuracy
        acc = eval_acc(state.params)
    return {"test_acc": acc}


def run_symbolic(cfg, out_dir, plots):
    """The reference's symbolic-regression demo (smooth_test_KAN_ferro.py):
    fit y = sin x + 0.1 x^2 with a 2-layer ferro-KAN and save the trained
    params (its `torch.save` of KAN_ferro_SR_trained.pth) as the JAX CLI
    saves them and, with ``plots``, the losses and both layers' P-E
    loops."""
    import numpy as np

    from fetode_tpu_torch.convert import symbolic_params_to_numpy
    from fetode_tpu_torch.models.symbolic import (
        SymbolicNetSpec,
        train_symbolic,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.device)
    spec = SymbolicNetSpec(hidden=cfg.hidden, num_basis=cfg.num_basis,
                           l1_coef=cfg.l1_coef)
    params, losses = train_symbolic(spec, epochs=cfg.epochs, lr=cfg.lr,
                                    n_points=cfg.n_points, seed=cfg.seed,
                                    log=lambda m: print(m, flush=True),
                                    device=device)
    np.savez(os.path.join(out_dir, "symbolic_trained.npz"),
             **{f"{layer}.{k}": v
                for layer, d in symbolic_params_to_numpy(params).items()
                for k, v in d.items()})
    if plots:
        from fetode_tpu_torch.diag.hysteresis import plot_loops
        from fetode_tpu_torch.diag.plots import plot_losses

        plot_losses({"loss": losses}, os.path.join(out_dir, "loss.png"))
        for name, cfg_l in (("l1", spec.l1_cfg), ("l2", spec.l2_cfg)):
            plot_loops(getattr(params, name), cfg_l,
                       os.path.join(out_dir, "hysteresis"), max_panels=6,
                       prefix=name)
    return {"final_loss": float(losses[-1]) if len(losses) else None,
            "initial_loss": float(losses[0]) if len(losses) else None}


def mnist_serving(cfg, device: torch.device):
    """The MNIST serving function: ``(params, fn, example)`` with a fresh
    Kuramoto classifier from ``cfg.seed`` under ``cfg.rollout`` and
    ``fn(params, x) -> (B, 10)`` logits of ``(B, 28, 28)`` images.  Under
    the fused rollout ``fn`` packs the head of the module it serves on its
    first call and passes that packing to every later call of the same
    module: served weights stay as they were loaded."""
    from fetode_tpu_torch.models.kuramoto import (
        KuramotoSpec,
        kuramoto_init,
        kuramoto_kan_apply,
        packed_head,
    )

    spec = KuramotoSpec(rollout=cfg.rollout)
    params = kuramoto_init(torch.Generator().manual_seed(cfg.seed), spec,
                           device=device)
    served = {}

    def fn(p, x):
        if spec.rollout != "pallas_fused":
            return kuramoto_kan_apply(p, spec, x)
        if served.get("params") is not p:
            served.update(params=p, packed=packed_head(p.head))
        return kuramoto_kan_apply(p, spec, x, packed=served["packed"])
    example = torch.zeros((1, spec.H, spec.W), dtype=torch.float32,
                          device=device)
    return params, fn, example


def ett_serving(cfg, device: torch.device):
    """The ETT serving function: ``(params, fn, example)`` with a fresh
    latent-ODE point forecaster from ``cfg.seed`` and ``fn(params, x) ->
    (B, pred_len)`` forecasts of ``(B, context_len, num_features)``
    windows."""
    from fetode_tpu_torch.models import forecasting as F

    spec = F.LatentODEForecasterSpec(num_features=cfg.num_features,
                                     context_len=cfg.context_len,
                                     pred_len=cfg.pred_len,
                                     latent_dim=cfg.latent_dim,
                                     solver_mode=cfg.solver_mode)
    params = F.latent_ode_forecaster_init(
        torch.Generator().manual_seed(cfg.seed), spec, device=device)

    def fn(p, x):
        return F.latent_ode_forecast(p, spec, x)
    example = torch.zeros((1, cfg.context_len, cfg.num_features),
                          dtype=torch.float32, device=device)
    return params, fn, example


def ddpm_serving(cfg, device: torch.device):
    """The diffusion forecaster's serving function: ``(params, fn,
    example)`` with a fresh MLP-encoder diffusion forecaster from
    ``cfg.seed``; ``fn(params, x)`` is the mean of ``cfg.n_samples``
    reverse chains of ``cfg.diff_t`` steps, drawn from a generator seeded
    ``cfg.seed + 1`` on every call, so a forecast is deterministic."""
    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.nn.diffusion import make_schedule

    spec = F.DiffusionForecasterSpec(num_features=cfg.num_features,
                                     context_len=cfg.context_len,
                                     pred_len=cfg.pred_len,
                                     latent_dim=cfg.latent_dim,
                                     diff_T=cfg.diff_t,
                                     solver_mode=cfg.solver_mode)
    sched = make_schedule(cfg.diff_t, device=device)
    params = F.diffusion_forecaster_init(
        torch.Generator().manual_seed(cfg.seed), spec, device=device)

    def fn(p, x):
        g = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        s = F.diffusion_forecaster_sample(p, spec, sched, x, g,
                                          n_samples=cfg.n_samples)
        return s if cfg.n_samples == 1 else s.mean(0)
    example = torch.zeros((1, cfg.context_len, cfg.num_features),
                          dtype=torch.float32, device=device)
    return params, fn, example


def ecg_serving(cfg, device: torch.device):
    """The ECG serving function: ``(params, fn, example)`` with a fresh
    KanFetNODE classifier (latent field ``cfg.field``) from ``cfg.seed``
    and ``fn(params, x) -> (B, num_classes)`` logits of ``(B, t_len)``
    series."""
    from fetode_tpu_torch.models import ecg as M

    spec = M.KanFetNODESpec(T=cfg.t_len, latent_dim=cfg.latent_dim,
                            num_basis=cfg.num_basis, rtol=cfg.rtol,
                            atol=cfg.atol, field=cfg.field,
                            solver_mode=cfg.solver_mode)
    params = M.kanfet_node_init(torch.Generator().manual_seed(cfg.seed), spec,
                                device=device)

    def fn(p, x):
        return M.kanfet_node_apply(p, spec, x)
    example = torch.zeros((1, cfg.t_len), dtype=torch.float32, device=device)
    return params, fn, example


def predprey_serving(cfg, device: torch.device):
    """The predprey serving function: ``(params, fn, example)`` with fresh
    parameters from ``cfg.seed`` and ``fn(params, x0s) -> (B, T, 2)``
    trajectories over ``linspace(0, horizon, n_points)``."""
    from fetode_tpu_torch.models.predprey import (
        PredPreyNODE,
        predict_batch,
        predprey_init,
    )
    from fetode_tpu_torch.ops.kanfet_node import kanfet_solve

    spec = PredPreyNODE.kanfet()
    params = predprey_init(torch.Generator().manual_seed(cfg.seed), spec,
                           device=device)
    ts = torch.linspace(0.0, cfg.horizon, cfg.n_points, dtype=torch.float32,
                        device=device)
    if cfg.solver_mode == "pallas":
        # The batched whole-solve kernel: the production serving path.
        def fn(p, x0s):
            return kanfet_solve(p, spec.kan, x0s, ts, rtol=spec.rtol,
                                atol=spec.atol, max_steps=spec.max_steps)
    else:
        eval_spec = spec._replace(solver_mode=cfg.solver_mode)

        def fn(p, x0s):
            return predict_batch(p, eval_spec, x0s, ts)
    example = torch.ones((1, 2), dtype=torch.float32, device=device)
    return params, fn, example


def cond_diffusion_serving(cfg, device: torch.device):
    """The conditional-diffusion serving function: ``(params, fn,
    example)`` with a fresh ``cfg.denoiser`` from ``cfg.seed``; ``fn(params,
    past)`` is the mean (B, pred_len, num_features) of ``cfg.n_samples``
    reverse chains of ``cfg.diff_t`` steps on the conditioning encoded once,
    drawn from a generator seeded ``cfg.seed + 1`` on every call, so a
    forecast is deterministic."""
    from fetode_tpu_torch.models.cond_diffusion import (
        cond_denoiser_init,
        make_denoiser_spec,
    )
    from fetode_tpu_torch.nn.diffusion import make_schedule
    from fetode_tpu_torch.train.cond_diffusion_driver import sample_forecasts

    spec = make_denoiser_spec(cfg.denoiser, d_in=cfg.num_features,
                              pred_len=cfg.pred_len, seq_len=cfg.context_len,
                              solver_mode=cfg.solver_mode)
    sched = make_schedule(cfg.diff_t, device=device)
    params = cond_denoiser_init(torch.Generator().manual_seed(cfg.seed), spec,
                                device=device)

    def fn(p, past):
        g = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        return sample_forecasts(p, spec, sched, past, g,
                                n_samples=cfg.n_samples).mean(0)
    example = torch.zeros((1, cfg.context_len, cfg.num_features),
                          dtype=torch.float32, device=device)
    return params, fn, example


SERVING = {"ecg": ecg_serving, "predprey": predprey_serving,
           "ett": ett_serving, "ddpm": ddpm_serving,
           "cond_diffusion": cond_diffusion_serving, "mnist": mnist_serving}


def _serve_ckpt_params(ckpt_dir):
    """The ``state_dict`` a training checkpoint holds for serving: its
    ``best_params``, else its train state's ``params`` (the JAX CLI's
    order).  The source's hyper-parameters must match the training
    run's."""
    from fetode_tpu_torch.train.checkpoint import CheckpointManager

    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir!r}")
    saved = CheckpointManager(ckpt_dir).restore()
    for keys in (("best_params",), ("state", "params")):
        node = saved
        try:
            for k in keys:
                node = node[k]
            return node
        except (KeyError, TypeError):
            continue
    raise ValueError(f"no params found in checkpoint at {ckpt_dir!r} "
                     f"(top-level keys: {list(saved)})")


def run_serve(cfg, out_dir, plots):
    """Export a serving bundle, load it back and bench it per bucket."""
    from fetode_tpu_torch.serve import export_servable, load_servable, serve_bench
    from fetode_tpu_torch.utils.device import resolve_device

    if cfg.source not in SERVING:
        raise ValueError(f"unknown serve source {cfg.source!r}; ported: "
                         f"{sorted(SERVING)}")
    device = resolve_device(cfg.device)
    params, fn, example = SERVING[cfg.source](cfg, device)
    if cfg.ckpt_dir:
        params.load_state_dict(_serve_ckpt_params(cfg.ckpt_dir))
        print(f"serving params restored from {cfg.ckpt_dir}")

    bundle = cfg.bundle_dir or os.path.join(out_dir, "bundle")
    t0 = time.perf_counter()
    meta = export_servable(bundle, params, example, buckets=cfg.buckets)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # A copy of the module is the skeleton the bundle's state loads into.
    sv = load_servable(bundle, fn, copy.deepcopy(params))
    load_s = time.perf_counter() - t0
    print(f"bundle {bundle}: export {export_s:.2f}s, load {load_s:.2f}s "
          f"on {meta['fingerprint']['device_kind']}")

    bench = []
    for b in meta["buckets"]:
        x = example.expand((b,) + tuple(example.shape[1:]))
        row = serve_bench(sv, x, iters=cfg.iters)
        print(f"  bucket {b}: p50 {row['p50_ms']:.2f} ms  "
              f"p99 {row['p99_ms']:.2f} ms  "
              f"{row['throughput_sps']:.0f} samples/s")
        bench.append(row)
    return {"source": cfg.source, "bundle": bundle,
            "buckets": meta["buckets"], "fingerprint": meta["fingerprint"],
            "export_s": export_s, "load_s": load_s, "bench": bench}


RUNNERS = {
    "predprey": run_predprey,
    "ecg": run_ecg,
    "ett": run_ett,
    "cond_diffusion": run_cond_diffusion,
    "timemmd": run_timemmd,
    "mnist": run_mnist,
    "symbolic": run_symbolic,
    "serve": run_serve,
}


def _init_device(name: str) -> None:
    """The CLI's first device touch, as the JAX CLI's: a CUDA device is
    initialised under ``device_init_watchdog`` (timeout
    ``$FETODE_DEVICE_TIMEOUT`` seconds, default 300; 0 waits forever)."""
    from fetode_tpu_torch.utils.debug import (
        device_init_watchdog,
        enable_compile_cache,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    enable_compile_cache()
    device = resolve_device(name)
    if device.type == "cuda":
        disarm = device_init_watchdog(
            float(os.environ.get("FETODE_DEVICE_TIMEOUT", "300")))
        torch.cuda.init()
        torch.empty(1, device=device)
        disarm()


def _run(args, cfg):
    """One process's run of the workload.  On a mesh rank 0 alone prints
    and writes ``result.json``, metrics, plots and checkpoints; the other
    ranks run the same steps with their output sent to a directory of
    their own that is thrown away."""
    from fetode_tpu_torch.parallel import is_rank0

    if is_rank0():
        os.makedirs(args.out_dir, exist_ok=True)
        print(f"workload={args.workload} config={cfg}")
        _init_device(cfg.device)
        result = RUNNERS[args.workload](cfg, args.out_dir, args.plots)
        with open(os.path.join(args.out_dir, "result.json"), "w") as f:
            json.dump(result, f, indent=2)
        print(json.dumps(result))
        return result
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(null):
        _init_device(cfg.device)
        return RUNNERS[args.workload](cfg, tmp, False)


def _rank_main(rank, argv):
    """A rank that ``main`` spawned: the same command line in a process of
    the group."""
    main(argv)


def main(argv=None):
    """Parse, and run the workload.  ``--mesh N`` (or ``data=D,model=M``;
    or the overrides ``--mesh_devices N`` and ``--mesh_model M``) trains
    over a mesh of N ranks, and predprey's ``--shooting_devices N``
    its shooting segments over N ranks: under torchrun (``WORLD_SIZE``
    set) every process is a rank of the group torchrun made; run alone,
    ``main`` starts the N local ranks itself (``parallel.spawn_local``:
    CUDA ranks on ``cuda:<rank>`` with NCCL, CPU ranks with gloo), waits
    for them and returns rank 0's result."""
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        parse_mesh_flag,
        spawn_local,
        world,
    )

    argv = list(argv if argv is not None else sys.argv[1:])
    args, overrides = _parse(argv)
    cfg = make_config(args.workload, overrides)
    if args.mesh and not hasattr(cfg, "mesh_devices"):
        raise SystemExit(f"--mesh is not supported by the "
                         f"{args.workload!r} workload")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed(device=cfg.device)
    if args.mesh:
        cfg.mesh_devices, cfg.mesh_model = parse_mesh_flag(args.mesh)
    ranks = (getattr(cfg, "mesh_devices", 0)
             or getattr(cfg, "shooting_devices", 0))
    if getattr(cfg, "mesh_devices", 0):
        make_mesh(cfg.mesh_devices, model=cfg.mesh_model)    # its shape
    if world()[1] > 1 and ranks != world()[1]:
        raise SystemExit(f"{world()[1]} ranks (WORLD_SIZE) need --mesh "
                         f"{world()[1]} or --mesh_devices {world()[1]} "
                         f"(predprey: --shooting_devices {world()[1]})")
    if world()[1] == 1 and ranks > 1:
        print(f"starting {ranks} ranks", flush=True)
        spawn_local(_rank_main, ranks, (argv,), device=cfg.device)
        with open(os.path.join(args.out_dir, "result.json")) as f:
            return json.load(f)
    return _run(args, cfg)


if __name__ == "__main__":
    main()
