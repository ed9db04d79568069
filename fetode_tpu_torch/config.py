"""Workload configuration presets + flag overrides (counterpart of
``fetode_tpu/config.py``).

Every workload's preset: ``predprey``, ``ecg``, ``ett``,
``cond_diffusion``, ``timemmd``, ``mnist``, ``symbolic`` and ``serve``;
their field names are the JAX package's, so one command line drives
either package.  The port adds ``device``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class PredPreyPreset:
    """train_kanfet_node_predprey.py:20-38 (lr 2e-3, 10k epochs,
    KANFET [2,10,2] grid 5, dopri5)."""

    epochs: int = 10_000
    epochs_per_call: int = 100
    lr: float = 2e-3
    layers: tuple = (2, 10, 2)
    grid_size: int = 5
    ferro_num_basis: int = 8
    method: str = "dopri5"
    rtol: float = 1e-7
    atol: float = 1e-9
    max_steps: int = 256
    # "auto" (the kernels on CUDA; on the CPU the eager scan under
    # autograd and the eager while solve for evaluation), "scan" (eager
    # differentiable solve), "while" (eager, no gradient), or "pallas"
    # (the discrete-adjoint CUDA kernels; CUDA only).
    solver_mode: str = "auto"
    # Fit at the times the window targets were actually sampled
    # (PredPreyRun.consistent_time_base).
    consistent_time_base: bool = False
    # Multiple shooting (PredPreyRun.shooting_points; 0 disables);
    # shooting_devices spreads the segments over that many ranks.
    shooting_points: int = 0
    shooting_devices: int = 0
    # Durable checkpoint/resume: --ckpt_dir D --ckpt_every N [--resume
    # true] (train/checkpoint.py); aot_cache is accepted and logged.
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class ECGPreset:
    """train_ecg_kan_fet_nn_ode.py:1181-1261 (100 epochs, batch 8, latent
    64, basis 12, dopri5 rtol 1e-2 atol 1e-3, AdamW 1e-3 wd 1e-4)."""

    # kanfet_node | kanfet_mlp_node | fepa_rnn | digital_rnn | node_rnn;
    # "all": the comparison set (cli.py: _run_ecg_all); "noise_study":
    # the clean-vs-noisy grid over noise_stds x noise_seeds as one
    # population (cli.py: _run_ecg_noise_study).
    model: str = "kanfet_node"
    noise_stds: str = "0,0.1,0.2,0.5"
    noise_seeds: str = "0,1,2"
    epochs: int = 100
    batch_size: int = 8
    lr: float = 1e-3
    weight_decay: float = 1e-4
    latent_dim: int = 64
    num_basis: int = 12
    solver: str = "dopri5"
    rtol: float = 1e-2
    atol: float = 1e-3
    noise_std: float = 0.0
    # Ferro gate form of kanfet_mlp_node only: "sigmoid" or "tanh" (the
    # eager solves only).
    gate_impl: str = "sigmoid"
    # "auto" (the kernels on CUDA; on the CPU the eager scan under
    # autograd and the eager while solve for evaluation), "scan",
    # "while", or "pallas" (the whole-solve CUDA kernels; CUDA only).
    solver_mode: str = "auto"
    # kanfet_node latent field: "plain" (No_MLP_KANODEFunc) or "mlp"
    # (MLPKANODEFunc: layer norm, mixer, a two-layer B-spline KAN; the
    # kernels of ops/mlp_node.py on CUDA).
    field: str = "plain"
    # Epochs per call of the block scanner (ECGRun.epochs_per_call).
    epochs_per_call: int = 1
    # The mesh (set by --mesh, parallel.parse_mesh_flag): ranks, and the
    # 'model' axis inside them (0 = one device).
    mesh_devices: int = 0
    mesh_model: int = 1
    # Durable checkpoint/resume: --ckpt_dir D --ckpt_every N [--resume
    # true] (train/checkpoint.py: DurableLoop); aot_cache is accepted and
    # logged.
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class ETTPreset:
    """train_kan_fet_ett.py:1341-1351 (ETTh1, context 96, pred 8, batch
    64, 100 epochs, AdamW 1e-3 wd 1e-4, latent 64)."""

    dataset: str = "ETTh1"
    target: str = "OT"
    # point | diffusion | kan_diffusion | kan_fet_diffusion (the KAN-RNN
    # context encoder).
    model: str = "point"
    context_len: int = 96
    pred_len: int = 8
    batch_size: int = 64
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-4
    latent_dim: int = 64
    diff_t: int = 200
    eval_samples: int = 10
    # "auto" (the kernels on CUDA; on the CPU the eager scan under
    # autograd and the eager while solve for evaluation), "scan",
    # "while", or "pallas" (the latent trajectory kernels of
    # ops/ode_dyn.py; CUDA only).  Evaluation on the card runs the
    # forward kernel without records.
    solver_mode: str = "auto"
    # The mesh (set by --mesh, parallel.parse_mesh_flag): ranks, and the
    # 'model' axis inside them (0 = one device).
    mesh_devices: int = 0
    mesh_model: int = 1
    # Durable checkpoint/resume: --ckpt_dir D --ckpt_every N [--resume
    # true] (train/checkpoint.py: DurableLoop); aot_cache is accepted and
    # logged.
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class CondDiffusionPreset:
    """kan_diffusion_ett.py:870-924 (seq 96, pred 24, T=250, batch 64,
    AdamW 2e-4, five denoiser variants)."""

    dataset: str = "ETTh1"
    # mlp, kan, kan_fet_linear_ode, kan_node or kan_fet_all_node
    denoiser: str = "kan_fet_all_node"
    seq_len: int = 96
    pred_len: int = 24
    diff_t: int = 250
    batch_size: int = 64
    epochs: int = 10
    lr: float = 2e-4
    eval_samples: int = 10
    # The NODE encoder's solve (kan_node, kan_fet_all_node): "auto" (the
    # kernels of ops/node_enc.py on CUDA, the eager solve on the CPU),
    # "scan", "while", or "pallas" (the kernels; CUDA only).  Evaluation
    # on the card runs the forward kernel without records.
    solver_mode: str = "auto"
    # The mesh (set by --mesh, parallel.parse_mesh_flag): ranks, and the
    # 'model' axis inside them (0 = one device).
    mesh_devices: int = 0
    mesh_model: int = 1
    # Durable checkpoint/resume: --ckpt_dir D --ckpt_every N [--resume
    # true] (train/checkpoint.py: DurableLoop); aot_cache is accepted and
    # logged.
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class TimeMMDPreset:
    """train_kan_fet_mmd*_multimodal.py:234-257 (context 50, pred 12,
    text SVD dim 7, batch 48, 50 epochs): the diffusion forecaster with
    the KAN-RNN context encoder."""

    domain: str = "Energy"           # Energy|Climate
    multimodal: bool = False
    context_len: int = 50
    pred_len: int = 12
    text_embed_dim: int = 7
    tfidf_max_features: int = 20_000
    batch_size: int = 48
    epochs: int = 50
    lr: float = 1e-3
    # The mesh (set by --mesh, parallel.parse_mesh_flag): ranks, and the
    # 'model' axis inside them (0 = one device).
    mesh_devices: int = 0
    mesh_model: int = 1
    # Durable checkpoint/resume: --ckpt_dir D --ckpt_every N [--resume
    # true] (train/checkpoint.py: DurableLoop); aot_cache is accepted and
    # logged.
    ckpt_dir: str = ""
    ckpt_every: int = 0
    resume: bool = False
    aot_cache: str = ""
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class MNISTPreset:
    """mnist_kuramoto_kan.py:210-247 (10 Kuramoto steps dt 0.15,
    3 epochs, batch 128, AdamW 1e-3)."""

    kuramoto_steps: int = 10
    dt: float = 0.15
    num_basis: int = 8
    epochs: int = 3
    batch_size: int = 128
    lr: float = 1e-3
    # "auto" (the kernels on CUDA, the scan on the CPU), "scan" (the plain
    # rollout), "pallas" (the rollout kernels of ops/kuramoto.py) or
    # "pallas_fused" (the fused rollout + head kernel; CUDA only).
    rollout: str = "auto"
    # The mesh (set by --mesh, parallel.parse_mesh_flag): ranks, and the
    # 'model' axis inside them (0 = one device).
    mesh_devices: int = 0
    mesh_model: int = 1
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class SymbolicPreset:
    """smooth_test_KAN_ferro.py:125-160 (2-layer ferro-KAN symbolic
    regression of y = sin x + 0.1 x^2 with L1 coef pruning)."""

    hidden: int = 8
    num_basis: int = 6
    l1_coef: float = 1e-3
    epochs: int = 300
    lr: float = 5e-3
    n_points: int = 128
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


@dataclass
class ServePreset:
    """Serving bundle export + latency bench (``fetode_tpu_torch/serve.py``)."""

    # What to serve.  Ported: "ecg" (the KanFetNODE classifier),
    # "predprey" (batched trajectory solve), "ett" (the latent-ODE point
    # forecaster), "ddpm" (the mean of n_samples reverse chains of the
    # diffusion forecaster), "cond_diffusion" (the mean of n_samples
    # reverse chains of a conditional denoiser, the conditioning encoded
    # once) and "mnist" (the Kuramoto classifier).
    source: str = "ecg"
    # Batch buckets (requests pad up / chunk down at serve time).
    buckets: tuple = (8, 64, 256)
    # Where the bundle goes ("" = <out-dir>/bundle).
    bundle_dir: str = ""
    # A training checkpoint to serve instead of a fresh init: its
    # best_params, else its train state's params (the source's
    # hyper-parameters must match the training run's).
    ckpt_dir: str = ""
    # Latency bench: timed calls per window (3 windows per bucket).
    iters: int = 30
    # ECG source hypers
    t_len: int = 96
    latent_dim: int = 64
    num_basis: int = 12
    # KanFetNODE latent field: "plain" or "mlp" (as ECGPreset.field).
    field: str = "plain"
    # "auto" (the kernel on CUDA, eager elsewhere), "pallas" (the
    # whole-solve kernel), "while" (eager early-exit solve).
    solver_mode: str = "auto"
    rtol: float = 1e-2
    atol: float = 1e-3
    # ETT, ddpm and cond_diffusion source hypers (ETT and ddpm also take
    # latent_dim above; the specs' own tolerances, rtol 1e-3 / atol 1e-4)
    num_features: int = 7
    context_len: int = 96
    pred_len: int = 8
    # predprey source: serve trajectories over linspace(0, horizon, n_points)
    horizon: float = 14.0
    n_points: int = 140
    # ddpm and cond_diffusion sources: the forecast is the mean of
    # n_samples reverse chains of diff_t steps, drawn from a generator
    # seeded seed + 1 on every call.
    n_samples: int = 10
    diff_t: int = 200
    # cond_diffusion source: which of the five denoiser variants to serve
    # (its node encoder takes solver_mode above).
    denoiser: str = "kan_node"
    # mnist source: the rollout of KuramotoSpec ("pallas_fused", the fused
    # rollout + head kernel, is the serving path; "scan", "pallas", "auto")
    rollout: str = "pallas_fused"
    seed: int = 0
    # "cuda" (refused when CUDA is absent) or "cpu".
    device: str = "cuda"


PRESETS = {
    "predprey": PredPreyPreset,
    "ecg": ECGPreset,
    "ett": ETTPreset,
    "cond_diffusion": CondDiffusionPreset,
    "timemmd": TimeMMDPreset,
    "mnist": MNISTPreset,
    "symbolic": SymbolicPreset,
    "serve": ServePreset,
}


def make_config(workload: str, overrides: Optional[Dict[str, Any]] = None):
    """Instantiate a preset with typed overrides; unknown keys error."""
    if workload not in PRESETS:
        raise ValueError(f"workload {workload!r} has no preset in the port; "
                         f"ported: {sorted(PRESETS)}")
    cls = PRESETS[workload]
    cfg = cls()
    for k, v in (overrides or {}).items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown option {k!r} for workload {workload!r};"
                             f" valid: {[f.name for f in dataclasses.fields(cls)]}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = str(v).lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        elif isinstance(cur, tuple):
            v = tuple(int(x) for x in str(v).strip("()[]").split(","))
        setattr(cfg, k, v)
    return cfg
