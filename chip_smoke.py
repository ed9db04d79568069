"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main paths — predprey KANFET serving and training, ECG
classification training and serving (the 'plain' and 'mlp' latent
fields and the ferro model), ETT forecasting training and serving,
Kuramoto-MNIST training and serving, conditional-diffusion training and
serving, predprey training on wide KANFET stacks, symbolic regression,
the ECG recurrent models (FEPA-RNN, NODE-RNN, the digital RNN,
``--model all``) with ETT's KAN-RNN encoder, the KAN layers' spline term
(B.12) on every KAN path, the custom-field whole-solve example (B.14),
and B.1 / B.2 on other pure-KANFET stacks — on the card and checks them,
in phases that run in order; any failure exits non-zero.

1. Device: CUDA must be present; prints the card's name and power limit.
2. Build: compiles every kernel of the paths from ``fetode_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together.
3. Serving kernel against its plain PyTorch version on the card, flagship
   parameters from a seed, B=256 initial conditions from U[0.5, 2.0], the
   140-point serving horizon: all points finite, rtol = atol = 1e-3 on
   the first 40 (the JAX package's own kernel tolerance).  Repeated with
   an attempt budget of max_steps=8, where each trajectory stops early.
4. The serving slice: ``cli.main(["serve", "--source", "predprey",
   "--solver_mode", "pallas", ...])`` with buckets (8, 64, 256), then
   requests of B = 1, 100 and 300 through the loaded bundle; their
   outputs must equal direct kernel calls, and the serving kernel must
   have launched.
5. Timing of the serving kernel and its plain version at B = 8, 64, 256.
6. Training kernels against their plain versions, B = 256 (U[0.5, 2.0])
   and B = 1 (the task's x0), the 35 fit times, targets from the LV
   field: the forward at rtol = atol = 1e-3, all finite; the backward on
   the forward kernel's own records against autograd of the plain replay
   of the same records, relative error < 1e-4 over all parameter
   gradients and over x0bar; the full kernel gradient against the full
   plain gradient, each on its own step mesh, cosine > 0.999.
7. The training slice: ``cli.main(["predprey", "--device", "cuda",
   "--solver_mode", "pallas", "--epochs", "200", "--epochs_per_call",
   "100"])`` and ``train_traj_parallel`` at n_traj = 256: both training
   kernels must have launched, the losses must be finite and fall.
8. Timing of a training step's forward, backward and whole step
   (forward + backward + Adam), kernels and plain, at B = 1 and 256.

The ECG classification slice, at the full width of ``ECGPreset`` (T =
96, latent 64, 12 bases, hidden 128, dopri5 at rtol 1e-2 / atol 1e-3,
max_steps 16), random weights from a seed, series from
``synthetic_ecg200``:

9. The logistic-mixer kernels (``csrc/logistic_node.cu``) against their
   plain versions at every batch the main path gives them, B = 8 (a
   training step), 32 and 64 (the accuracy evals) and 256 (the largest
   serving bucket): the forward, with and without records, at rtol =
   atol = 1e-3 and the same attempt counts;
   the backward on the forward kernel's own records against autograd of
   the plain replay of the same records, relative error < 1e-4 over all
   parameter gradients and over h0bar; full gradients, each on its own
   step mesh, cosine > 0.999.
10. The same checks for the ferro kernels (``csrc/ferro_node.cu``) at
    B = 8, 32 and 64, clean and with frozen device noise of std 0.2 (one
    set of draws for each batch, fed to both).
11. The training slice: ``cli.main(["ecg", "--device", "cuda",
    "--solver_mode", "pallas", ...])`` for ``kanfet_node``,
    ``kanfet_mlp_node`` and ``kanfet_mlp_node --noise_std 0.2``: both
    kernels of each model must have launched and the losses must be
    finite.
12. The serving slice: ``cli.main(["serve", "--source", "ecg",
    "--solver_mode", "pallas", ...])`` with buckets (8, 64, 256), then
    requests of B = 1, 30 and 300 through the loaded bundle; they must
    equal direct kernel calls on the same padded batches, and the forward
    kernel must have launched.
13. Timing: each ECG kernel and its plain version at B = 8 and at the
    serving buckets, and one ECG training step of each model, kernels
    against the eager solve.

The ETT forecasting slice, at the full width of ``ETTPreset`` (context
96, pred_len 8 at times 0..7, latent 64, hidden 128, dopri5 at rtol 1e-3 /
atol 1e-4, max_steps 32; diffusion T = 200, eps-head hidden 256, 10
samples), random weights from a seed, windows of the synthetic series
(2,000 steps, 7 columns) that ``cli ett`` falls back to:

14. The latent trajectory kernels (``csrc/ode_dyn.cu``) against their
    plain versions at every batch the path gives them: 64 (a training
    step), 97 (the validation split), 297 (the point forecaster's test
    split), 256 and 41 (the diffusion test chunks), 1 (the final
    forecast) and 8 / 64 / 256 (serving): the forward, with and without
    records, at rtol = atol = 1e-3 and the same attempt counts; at 64 and
    297 the backward on the forward kernel's own records against autograd
    of the plain replay of the same records, relative error < 1e-4, and
    full gradients, each on its own step mesh, cosine > 0.999.
15. The DDPM chain kernel (``csrc/ddpm.cu``) against its plain chain on
    the same y0 and noise tables at every row count the path gives it
    (10 samples times the batch): 10 (the final forecast), 80, 640 and
    2,560 (serving), 970, 2,560 and 410 (the validation and test chunks):
    rtol = atol = 1e-3; the same bits in two calls, and rows 0 and R-1
    solved alone the same bits as inside their batch (the contract of
    the kernel's row tiles, which follow R).
16. The training slice: ``cli.main(["ett", "--model", "point" |
    "diffusion" | "kan_diffusion", "--solver_mode", "pallas", "--epochs",
    "2", ...])``: the kernels of each model must have launched and the
    losses must be finite.
17. The serving slice: ``cli.main(["serve", "--source", "ett" | "ddpm",
    "--solver_mode", "pallas", ...])`` with buckets (8, 64, 256), then
    requests of B = 1, 30 and 300 through the loaded bundle; they must
    equal direct calls on the same padded batches, and the kernels must
    have launched.  Each bucket's p50 / p99 and its device-busy share
    (the profiler over calls of that bucket), with the card's name and
    power limit.
18. Timing: each forecasting kernel and its plain version at the path's
    batches (B.9 at 80, 640, 970 and 2,560 rows beside its bound), and
    one training step of each forecaster at B = 64, kernels against the
    eager solve.

The Kuramoto-MNIST slice, at the full width of ``MNISTPreset`` (28 x 28
lattice, 10 Euler steps of 0.15, KANLinear(1568 -> 10) head with grid 5,
order 3 and 8 logistic bases), random weights from a seed with omega =
0.3 randn and K = 0.7 in the kernel checks, images from
``synthetic_digits`` (the data ``cli mnist`` falls back to):

19. The rollout kernels (``csrc/kuramoto.cu``, B.10) against their plain
    versions at every batch the path launches: 128 (a training step and
    the synthetic test eval) and 1,024 (a larger eval batch; the synthetic
    data leaves no partial batch): features max |diff| <= 1e-4; the
    backward (theta0bar, omegabar, Kbar) against autograd of the plain
    rollout and against ``kuramoto_rollout_bwd_reference``, relative <
    1e-4; omegabar and Kbar the same bits in two calls.
20. The fused classifier kernel (B.11) against
    ``kuramoto_logits_reference`` at 8, 64 and 256 (serving), 128 and
    1,024: rtol = atol = 1e-3; the ``pallas_fused`` gradient against the
    ``pallas`` path's, relative < 1e-4.
21. The training slice: ``cli.main(["mnist", "--rollout", "pallas" |
    "pallas_fused", ...])``, 3 epochs each (the preset), and ``--rollout
    auto`` for one epoch: the kernels of each path must have launched and
    the epoch losses must be finite.
22. The serving slice: ``cli.main(["serve", "--source", "mnist", ...])``
    (the fused kernel) with buckets (8, 64, 256), then requests of B = 1,
    30 and 300 through the loaded bundle; they must equal direct calls on
    the unpadded batch (the images are independent), the kernel must
    have launched, and the serving function must have packed the head
    once for all requests.
23. Timing: each Kuramoto kernel and its plain version at B = 128, 256
    and 1,024 (the fused kernel also at 8 and 64), and one training step
    at B = 128 with the rollout kernels, the fused kernel and the scan.
    A Kuramoto kernel's time is its device time on a full queue
    (``queued_ms``): back to back, the host's launch overhead paces these
    small kernels, and that per-call time is printed beside it.

The conditional-diffusion slice, at the full width of
``CondDiffusionPreset`` (seq_len 96, pred_len 24, T = 250, batch 64; the
NODE encoder at C = P = H = 128, dopri5 at rtol 1e-3 / atol 1e-4,
max_steps 24) and of ``ServePreset``'s cond_diffusion source (kan_node, 7
features, context 96, pred_len 8, T = 200, 10 samples), random weights
from a seed, windows of the synthetic series (1,500 steps, 7 columns)
that ``cli cond_diffusion`` falls back to:

24. The node-encoder kernels (``csrc/node_enc.cu``, B.8) against their
    plain versions at every batch the path launches: 64 (a training
    step), 31 and 181 (the validation loss and the test forecast) and
    8 / 64 / 256 (serving), which phases 25-26 confirm by logging the
    batch of every launch: the forward, with and without records, at
    rtol = atol = 1e-3 and the same attempt counts; the backward on the
    forward kernel's own records against autograd of the plain replay of
    the same records, relative error < 1e-4 over the nine field / LN
    gradients, z0bar and the x_seq cotangent, the same bits in two calls;
    full gradients, each on its own step mesh, cosine > 0.999.
25. The training slice: ``cli.main(["cond_diffusion", "--denoiser",
    "kan_fet_all_node" | "kan_node", "--epochs", "1", ...])`` under the
    default ``solver_mode="auto"``: both kernels of each run must have
    launched and the losses must be finite.
26. The serving slice: ``cli.main(["serve", "--source", "cond_diffusion",
    ...])`` with buckets (8, 64, 256) and ``SERVE_ITERS`` timed calls a
    window, then requests of B = 1, 30 and 300 through the loaded bundle;
    they must equal direct calls on the same padded batches (the padding
    rows share the encoder's step control), and the forward kernel must
    have launched.  Each bucket's p50 / p99 and device-busy share, as in
    phase 17.
27. Timing: the node-encoder kernels and their plain versions at B = 64
    and 256, and one ``kan_fet_all_node`` training step at B = 64,
    kernels against the eager solve, with its device-busy share.

The ECG ``kanfet_node --field mlp`` slice, at the full width of
``ECGPreset`` (T = 96, latent 64, 12 bases, the KAN [768, 128, 128] with
grid 5 and order 3, dopri5 at rtol 1e-2 / atol 1e-3, max_steps 16),
random weights from a seed, series from ``synthetic_ecg200``:

28. The 'mlp' field kernels (``csrc/mlp_node.cu``, B.6) against their
    plain versions at every batch the path launches, B = 8 (a training
    step), 64 and 32 (the accuracy evals) and 256 (the largest serving
    bucket), which phases 29-30 confirm by logging the batch of every
    launch, for two parameter sets: the init (its field is tiny, one
    step) and a scaled one (out_w with std 4, log_alpha 0.5, the KAN
    weights tripled; several attempts): the forward, with and without
    records, at rtol = atol = 1e-3 and the same attempt counts; the
    backward on the forward kernel's own records against autograd of the
    plain replay of the same records, relative error < 1e-4 over all
    gradients together, over each of the 11 on its own and over h0bar,
    the same bits in two calls; full gradients, each on its own step
    mesh, cosine > 0.999.
29. The training slice: ``cli.main(["ecg", "--model", "kanfet_node",
    "--field", "mlp", "--solver_mode", "pallas", "--epochs", "3",
    ...])``: both kernels must have launched and the losses must be
    finite.
30. The serving slice: ``cli.main(["serve", "--source", "ecg", "--field",
    "mlp", "--solver_mode", "pallas", ...])`` with buckets (8, 64, 256),
    then requests of B = 1, 30 and 300 through the loaded bundle; they
    must equal direct kernel calls on the same padded batches, and the
    forward kernel must have launched.
31. Timing: the B.6 kernels and their plain versions at B = 8 and 64
    (the kernels also at 256 and with the scaled set at 8), and one
    training step at B = 8, kernels against the eager solve, with its
    device-busy share.

The wide predprey slice, the preset of ``cli predprey`` (dopri5 at rtol
1e-7 / atol 1e-9, ``max_steps`` 256, the 35 fit times over [0, 3.5], x0 =
(1, 1)) with ``--layers`` widened, random weights from a seed:

32. The wide-stack kernels (``csrc/kanfet_wide.cu``, B.3) against their
    plain versions at [2, 32, 2], [2, 24, 24, 2] and [2, 64, 64, 2] (ferro
    N = 512, 4,608, 32,768), B = 1 (the path's batch) and 3, for the init
    and a scaled set (every ferro coef and base weight times 1.5), at two
    tolerances: rtol 1e-3 / atol 1e-5, where float32 rounding decides no
    accept decision and the kernel must take plain's attempts, and the
    preset's, where it decides some and the kernel must take plain's
    attempts within 5% (at least 3) and reach plain's time: both
    forward kernels against plain's replay of the kernel's mesh at rtol =
    atol = 1e-3, the same output with and without records, the same
    output and records twice (each kernel one thread-block cluster, its
    size from ``ops/kanfet_wide.py: cluster_plan``, printed), and at the
    preset against the plain solve on its own mesh on the times both
    reached (at 1e-3 the two meshes' outputs part by the solve's own
    error); with the training loss's
    cotangent, the backward on the kernel's own records, twice the same
    bits, against autograd of the float64 plain replay of the same
    records, relative error < 1e-4 over the operands' gradients and over
    x0bar; a number that misses 1e-4 is held to 4× the float32 plain
    replay's own error, at most 1e-3, and its line says so (an x0bar that
    cancels to 1% of its terms: float32 cannot reach 1e-4 there); at
    rtol 1e-3, where the two meshes part
    most, the kernel's gradient against plain's, each on its own mesh,
    cosine > 0.999.
33. B.3 against B.2 (``kanfet_adjoint_fwd`` / ``bwd``) at [2, 32, 2] and
    B = 1: at rtol 1e-3 the same attempts; at the preset trajectories and
    gradients on their own meshes within 1e-4,
    and B.3's backward on B.2's records within 1e-4 of B.2's; at the
    flagship [2, 10, 2] (N = 160) trajectories within 1e-4; then both
    kernels timed, forward and backward, at the preset and B = 1 at ferro
    N = 160, 512, 4,608 and 32,768 (``CROSS_STACKS``), and the crossover
    over N printed (where B.3 is the faster).
34. A ``predict`` training step at [2, 64, 64, 2] (forward, backward,
    clip, Adam at learning rate 0): its time (CUDA events, median of 3
    windows), its device-busy share, B.3's forward and backward against
    plain, the attempts, and the launches: B.3 only, B.1 and B.2 none.
    Then a stack past B.3's cluster, [2, 80, 80, 2]: its ``predict``
    step launches B.2 (forward and backward) and no B.3, with a finite
    loss and gradients, and its ``predict`` without autograd (B.1) is
    within rtol = atol = 1e-3 of the plain eager solve.
35. The training slice: ``cli.main(["predprey", "--layers", "2,64,64,2",
    "--epochs", "20", ...])`` under ``solver_mode="auto"``: B.3 launched
    (and B.1 and B.2 not), finite losses; then ``cli.main(["symbolic",
    "--device", "cuda"])``: its loss finite and falling.

The ECG recurrent slice, at the full width of ``ECGPreset`` (T = 96,
hidden = latent 64, 12 bases, batch 8, AdamW 1e-3), random weights from
a seed, series from ``synthetic_ecg200``:

36. The ferro layer op (``csrc/ferro_fused.cu``, B.13) against the plain
    ``ferro_apply`` at every shape its paths give it (``RNN_SHAPES``: 1 ->
    64, 64 -> 64, 65 -> 64 with K = 12, at B = 8, 32 and 64;
    ``SYM_SHAPES``: cli symbolic's 1 -> 8 and 8 -> 1 with K = 6 at its 128
    points), states fresh, after one call and after 96 calls on random
    inputs, float32 and bfloat16 states, both gate forms: y within rtol =
    atol = 1e-4 against max |y|, the float32 branch within 1e-5 and a
    bfloat16 branch within one bfloat16 unit of plain's rounding, prev_x
    equal, y and the new branch the same bits in two calls, and the
    gradients of a random cotangent through the ``autograd.Function``
    within 1e-6 relative of autograd of the plain op;
    ``update_branch=False`` returns the old branch.
37. The sequence paths, kernel against plain: ``ferro_kan_rnn_apply`` at
    B = 8 and 64, ``node_rnn_apply`` (rk4, 96 steps) at B = 8 and 32:
    logits and cross-entropy gradients within 1e-4 relative, and exactly
    2 T + 1 = 193 and 4 * 96 + 2 = 386 B.13 launches a forward.
38. The CLI paths with ``--device cuda``: ``cli ecg --model fepa_rnn``
    and ``node_rnn`` (2 epochs; B.13 launched), ``fepa_rnn --noise_std
    0.2`` (B.13 not launched: its noise takes the plain op), ``digital_rnn``,
    ``all`` (1 epoch), ``cli ett --model kan_fet_diffusion`` (1 epoch) and
    ``cli symbolic`` (B.13 launched): finite losses, the batches B.13
    launched at logged.
39. Times: at each shape at B = 8 and 64, the device time per call of
    B.13 and of the plain op on a full queue (``queued_ms``; back to back
    the host's launch overhead paces them, and that per-call time, CUDA
    events, is printed beside it), with B.13's bound; a training step of
    ``fepa_rnn``, ``node_rnn`` (each also with the plain op) and
    ``digital_rnn`` at B = 8, learning rate 0 (CUDA events, median of 3
    windows), with its device-busy share.

The KAN layers' spline term (``csrc/spline.cu``, B.12), at the full
width of every KAN path (the cond-diffusion serving chain of
``ServePreset``, the cond-diffusion KAN nets of ``CondDiffusionPreset``,
MNIST's head, ETT ``kan_diffusion``'s encoder), and the custom-field
example (``csrc/custom_field.cu``, B.14), random weights from a seed.
From phase 3 on, every B.12 launch logs its shape, and the CLI runs of
phases 16, 21, 25 and 26 count B.12's launches (the count set to 0 just
before each run, read just after):

40. B.12 against the plain basis-and-product at every shape of
    ``SPLINE_SHAPES`` (the serving chain's three layers at R = 80, 640
    and 2,560, the first on the column slice of the 312-wide layer as
    ``_kan_partial`` passes it, the hoisted cond and t-embedding terms,
    training at B = 64 and the eval batches 31 and 181, MNIST's head, R =
    1 and 13) and at every other shape phases 3-39 launched: x ~ 1.2 N(0,
    1), some of it past the knots; y within rtol = atol = 2e-5
    (``tests/test_pallas_spline.py``'s), the same bits twice; at the listed
    shapes rows 0, R/2 and R-1 alone the same bits as inside the batch,
    and the gradients of x, the spline weight and the scaler through
    autograd within 1e-6 relative of autograd of plain; inputs off the
    grid and on its end knots, and rows with none inside the grid exactly
    zero; NaN and infinite inputs, whose rows are NaN as plain's.  Each
    distinct layer of ``SPLINE_SHAPES`` again at ``SPLINE_MULTI_ROWS``
    rows (many row tiles, so many clusters of its input groups, and a
    ragged last tile; MNIST's 1,568 -> 10 with its narrow output tile and
    8 input groups) with the same checks.
41. B.14 against ``ops/node_common.py``'s plain solve and replay at the
    example's size (D 4, H 8, B 3, weights 0.5 N(0, 1)) and at D = 64, H
    = 128, B = 8, 64 and 256 (weights N(0, 1) / sqrt(fan-in)), rtol 1e-4
    / atol 1e-6, 32 attempts: both forward kernels within 1e-3, the
    attempts as plain's and the time reached its records' and within 1e-4
    of plain's (also where a budget of 3 attempts runs out); the backward
    on its own records against autograd of the plain replay, relative <
    1e-4, the same bits twice; then the example's own check
    (``fetode_tpu_torch.examples.custom_field_kernel``: the forward
    against the eager while solve < 1e-4, each gradient's cosine against
    autograd of the eager scan solve > 0.9999), in this process (its
    launches counted) and as ``python -m`` in a subprocess, whose last
    line must be the verified line.
42. ``cli.main(["serve", "--source", "cond_diffusion", ...])`` (kan_node,
    buckets 8 / 64 / 256): B.12 launched at rows 80, 640 and 2,560, the
    requests B = 1, 30 and 300 through the bundle equal direct calls on
    the padded batches; a training step (learning rate 0) each of
    cond_diffusion ``kan_node`` and ``kan_fet_all_node`` at B = 64, MNIST
    ``pallas`` at 128 and ETT ``kan_diffusion`` at 64: finite losses, B.12
    launched; B.12 launched in phases 16 (``kan_diffusion``), 21
    (``pallas``), 25 and 26; shapes first launched here are checked as in
    phase 40.
43. Times: B.12 at ``SPLINE_TIMED`` (the serving chain's nine shapes,
    MNIST's head and ETT ``kan_diffusion``'s two encoder layers), the
    device time per call of it (its kernel and, with more than one input
    group, the groups' sum), of the plain version and of ``torch.matmul``
    of the product alone on precomputed bases (context: no PyTorch call
    computes basis and product), each on a full queue (``queued_ms``:
    CUDA events, the stream held busy while the host enqueues the calls,
    no profiler; rows 10, 11 and 13 are timed so too), and the time a
    call back to back of B.12 and plain; B.14's
    kernels and plain at D = 64, H = 128, B = 64; the serve p50 / p99 per
    bucket and the four steps of phase 42, each with B.12 and with the
    plain product (``plain_spline`` switches the layers' dispatch inside
    this script only).

B.1 and B.2 on other pure-KANFET stacks (``STACKS_44``), the predprey
preset (dopri5 at rtol 1e-7 / atol 1e-9, ``max_steps`` 256), random
weights from a seed, x0 from U[0.5, 2.0]:

44. At [2, 4, 4, 2] grid 7, [2, 128, 2] and [3, 10, 3] (B = 64), [2, 24,
    24, 2] (B = 8), [2, 64, 64, 2] (B = 2, its parameters read from
    global memory) and [2, 6, 2] at spline order 6 (B = 8; the window
    recursion in the warp's scratch, more than 16 knots): B.1 against its
    plain version on the first 40 of the 140 serving times and B.2's
    forward on the 35 fit times, rtol = atol = 1e-3; with the training
    loss's cotangent (the Lotka-Volterra truth, 1 in a third component),
    the backward on its own records twice (the same bits) against
    autograd of the plain replay of the same records, relative error <
    1e-4 (phase 6's gate; a miss is held to the float64 replay under
    phase 32's ``GRAD_CAP`` rule); the full gradient against plain's,
    each on its own mesh, cosine > 0.999; at the two wide stacks phase
    32's attempt contract, row by row (at rtol 1e-3 plain's attempts, at
    the preset within 5%, at least 3, and plain's time).  The flagship at
    B = 8 with the warps' scratch and gradients forced to global memory:
    the same forward and x0bar bits as in shared memory, gradients
    within 1e-6.  Then ``cli.main(["predprey", "--layers", "2,4,4,2",
    "--grid_size", "7", "--solver_mode", "pallas", "--epochs", "20",
    ...])`` and ``train_traj_parallel`` on [2, 24, 24, 2] at 8
    trajectories for 2 epochs: B.1 and both B.2 kernels launched (B.2's in
    the driver), finite losses.  Times of the three kernels at each stack
    on a full queue (``queued_ms``) and of their plain versions (one call,
    CUDA events: their while solves wait on the device at every step, so
    they cannot queue), with the kernels' bounds.

Every kernel's line carries ``bound_ms``: the larger of the bytes the
call must move over the card's memory rate and the operations it does
over the peak rate of the unit that runs them, counted from this run's
shapes and attempt counts (``*_counts`` below).

Its last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error, times and bound.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 1e-3          # rtol = atol, on the first N_CHECK output times
N_CHECK = 40
T_SERVE = 140
HORIZON = 14.0
GRAD_TOL = 1e-4     # relative, kernel vs plain replay on one step mesh
COS_MIN = 0.999     # kernel vs plain gradient, each on its own mesh
KERNELS = ("kanfet_node", "kanfet_adjoint", "logistic_node", "ferro_node",
           "ode_dyn", "ddpm", "kuramoto", "node_enc", "mlp_node",
           "kanfet_wide", "ferro_fused", "spline", "custom_field")
ECG_BATCHES = (8, 64, 256)     # the training batch is 8; serving buckets
ECG_CHECKS = (8, 32, 64, 256)  # and 64 / 32, the train / test eval batches
# The forecasting path's latent-solve batches and chain rows (phase 14-15).
ODE_CHECKS = (1, 8, 41, 64, 97, 256, 297)
ODE_BACKWARD = (64, 297)
DDPM_ROWS = (10, 80, 410, 640, 970, 2560)
# The Kuramoto path's batches (phases 19-20, 23).
KURA_CHECKS = (128, 1024)
KURA_LOGITS = (8, 64, 128, 256, 1024)
KURA_TIMES = (128, 256, 1024)
# The conditional-diffusion path's node-encoder batches (phase 24): 64 (a
# training step), 31 and 181 (the validation loss and the test forecast
# on the synthetic stand-in), 8 / 64 / 256 (serving).
NODE_ENC_CHECKS = (8, 31, 64, 181, 256)
# The ECG 'mlp' field's B.6 batches (phase 28): 8 (a training step), 64
# and 32 (the train and test accuracy evals), 8 / 64 / 256 (serving),
# which phases 29-30 confirm by logging the batch of every launch.
MLP_CHECKS = (8, 32, 64, 256)
# The wide predprey stacks of phase 32: the dispatch boundary (ferro N =
# 512), 4,608 and 32,768; and the tolerance at which float32 rounding
# decides no accept decision, where B.3 must take its plain version's
# attempts (at the preset's rtol 1e-7 two float32 solves part by a few).
WIDE_STACKS = ((2, 32, 2), (2, 24, 24, 2), (2, 64, 64, 2))
# Phase 33's crossover: the flagship (ferro N = 160) and the wide stacks.
CROSS_STACKS = ((2, 10, 2),) + WIDE_STACKS
# A stack whose backward no cluster of 16 CTAs holds (phase 34): its
# ``predict`` takes B.1 / B.2.
WIDE_PAST_CLUSTER = (2, 80, 80, 2)
WIDE_LOOSE = dict(rtol=1e-3, atol=1e-5)
# At the preset B.3 must reach plain's time in plain's attempts within
# this share of them, and at least 3 (float32 rounding of the error
# estimate parts two right solves: 105 against 101 at [2, 64, 64, 2]).
WIDE_ATTEMPTS = 0.05
# Phase 44's pure-KANFET stacks (layers, grid size, spline order, batch)
# for B.1 and B.2, and the two wide ones, held also to phase 32's attempt
# contract.  The last takes the kernels' paths for an order above 5 and
# more than 16 knots (the window recursion in the warp's scratch, the
# knot search as a loop).
STACKS_44 = (((2, 4, 4, 2), 7, 3, 64), ((2, 128, 2), 5, 3, 64),
             ((3, 10, 3), 5, 3, 64), ((2, 24, 24, 2), 5, 3, 8),
             ((2, 64, 64, 2), 5, 3, 2), ((2, 6, 2), 5, 6, 8))
STACKS_44_WIDE = ((2, 24, 24, 2), (2, 64, 64, 2))
# A backward check that misses GRAD_TOL is held instead to 4x the float32
# plain replay's own error against float64, never above this.
GRAD_CAP = 1e-3
# Timed calls per window of the cond_diffusion serving bench (3 windows a
# bucket): each call runs 10 reverse chains of 200 steps.
SERVE_ITERS = 3
# The ferro layer ops (P -> O, K) of the ECG recurrent models at ECGPreset's
# width (phases 36-39): the FEPA-RNN's input op, its hidden op and head
# (and node_rnn's cell), node_rnn's field on [h, x(t)]; cli symbolic's two
# layers.  The batches: 8 (a training step), 64 and 32 (the train and test
# accuracy evals), symbolic's 128 points; states after 0, 1 and T calls.
RNN_SHAPES = ((1, 64, 12), (64, 64, 12), (65, 64, 12))
SYM_SHAPES = ((1, 8, 6), (8, 1, 6))
RNN_BATCHES = (8, 32, 64)
SYM_BATCH = 128
RNN_T = 96
# B.12's shapes (rows, in, out, the inputs' column slice of the layer or
# None) on its paths (phase 40): the cond-diffusion serving chain at 10
# samples a request, R = 80 / 640 / 2,560 in buckets 8 / 64 / 256, through
# its first layer restricted to the 56 y dims of 312, its 256 -> 256 and
# 256 -> 56 layers, and the hoisted cond (the 128 dims after y, at R rows)
# and t-embedding (the last 128, at 200 rows) terms; cond-diffusion
# training at B = 64 (424 -> 256 -> 256 -> 168) and its eval batches 31 and
# 181; MNIST's head (1,568 -> 10) at 128; extra rows 1 and 13.  Every other
# shape the earlier phases launch is logged as they run and checked too.
SPLINE_SERVE_ROWS = (80, 640, 2560)
SPLINE_SHAPES = tuple(
    [(r, 56, 256, (0, 312)) for r in SPLINE_SERVE_ROWS]
    + [(r, 256, 256, None) for r in SPLINE_SERVE_ROWS]
    + [(r, 256, 56, None) for r in SPLINE_SERVE_ROWS]
    + [(r, 128, 256, (56, 312)) for r in SPLINE_SERVE_ROWS]
    + [(200, 128, 256, (184, 312))]
    + [(b, i, o, None) for b in (64, 31, 181)
       for i, o in ((424, 256), (256, 256), (256, 168))]
    + [(128, 1568, 10, None), (1, 256, 256, None), (13, 256, 256, None)])
# Phase 43 times the serving chain's nine shapes, MNIST's head and ETT
# kan_diffusion's encoder (672 -> 128 -> 64 at its training batch).
SPLINE_TIMED = SPLINE_SHAPES[:9] + ((128, 1568, 10, None),
                                    (64, 672, 128, None),
                                    (64, 128, 64, None))
# Phase 40 also runs each distinct layer of SPLINE_SHAPES at this many
# rows: more than one row tile (64 rows at most) and so more than one
# cluster of B.12's input groups, with a ragged last tile.
SPLINE_MULTI_ROWS = 1000
SPLINE_TOL = 2e-5    # rtol = atol, tests/test_pallas_spline.py's
SPLINE_GRAD_TOL = 1e-6
# B.14 (phase 41): the example's size, and the scaffold's scale with
# weights ~ 1/sqrt(fan-in); the JAX example's tolerances.
CUSTOM_SMALL = (4, 8, 3)
CUSTOM_DH = (64, 128)
CUSTOM_BATCHES = (8, 64, 256)
CUSTOM_OPTS = dict(rtol=1e-4, atol=1e-6, max_steps=32)
CUSTOM_COS = 0.9999

# Peak rates of one H100 SXM at 700 W: HBM and FP32 outside the tensor
# cores from NVIDIA's data sheet; the special-function unit (exp2,
# reciprocal, ...) at 16 results per SM per clock (Hopper architecture
# white paper) and the 1.98 GHz boost clock.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
SFU_OPS_S = 132 * 16 * 1.98e9
# What the counts below assume for one call, as (FP32 operations, SFU
# results): a sigmoid 1 / (1 + exp(-z)) and a tanhf each (4, 2).
SIG = TANH = (4, 2)
# Read off the SASS that nvcc -O3 emits for sm_90a (cuobjdump -sass),
# counting an FFMA as two operations and any other FP32 instruction as
# one: sincosf's fast path (|x| < 105615, always taken by the phases) is
# 11 FFMA, 2 FMUL, 4 FSEL, FSETP, F2I and I2FP, 31 operations and no SFU
# result; expf is 4 FFMA, FADD and FMUL plus MUFU.EX2, (10, 1); an IEEE
# division is 5 FFMA and FCHK plus MUFU.RCP, (11, 1).
SINCOS, EXP, DIV = (31, 0), (10, 1), (11, 1)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def frontier(y):
    """Per row, the first output index from which the trajectory holds one
    state to the end (where a truncated solve stopped)."""
    moving = ~np.all(y == y[:, -1:, :], axis=-1)            # (B, T)
    last = np.where(moving.any(axis=1),
                    moving.shape[1] - 1 - np.argmax(moving[:, ::-1], axis=1),
                    -1)
    return last + 1


def cuda_ms(fn, reps, windows=3):
    """Median over windows of the per-call time of ``fn``, CUDA events."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / reps)
    return float(np.median(per_call))


def flat(grads):
    return torch.cat([g.reshape(-1) for g in grads])


def rel_err(a, b):
    return float((a - b).norm() / b.norm())


def max_abs(a, b):
    return float((a - b).abs().max())


# ---------------------------------------------------------------- bounds


def bound(fp32, sfu, nbytes):
    """(bound_ms, bound_by, unit) of one call: the larger of its bytes over
    the memory rate and its operations over the rate of their unit."""
    t = {"bytes": nbytes / HBM_BYTES_S, "fp32": fp32 / FP32_OPS_S,
         "sfu": sfu / SFU_OPS_S}
    unit = max(t, key=t.get)
    return t[unit] * 1e3, ("bytes" if unit == "bytes" else "operations"), unit


def kanfet_eval_counts(cfg):
    """(FP32, SFU) of one KANFET field evaluation of one trajectory: per
    edge the SiLU base, the Cox-de Boor recursion and spline weights, and
    K ferro terms of two sigmoids and a tanh."""
    fp32 = sfu = 0
    for c in cfg.layers:
        i, o, K = c.in_features, c.out_features, c.ferro_num_basis
        C = c.grid_size + c.spline_order
        nk = c.grid_size + 2 * c.spline_order + 1
        fp32 += i * (2 + SIG[0]) + 2 * i * o
        fp32 += i * nk * (1 + 10 * c.spline_order) + 2 * i * o * C
        fp32 += i * (1 + SIG[0]) + i * o * K * (12 + 2 * SIG[0] + TANH[0])
        sfu += 2 * i * SIG[1] + i * o * K * (2 * SIG[1] + TANH[1])
    return fp32, sfu


def kanfet_counts(params, cfg, recs, T, kind):
    """(FP32, SFU, bytes) of a predprey kernel call from its records (the
    attempts each trajectory made): ``serve`` (solve and dense output at T
    times), ``fwd`` (the same plus the records) or ``bwd`` (6 field VJPs
    of about three evaluations each per accepted attempt: stage 7's
    cotangent is zero, since b[6] = 0)."""
    ev = kanfet_eval_counts(cfg)
    D = cfg.layers[0].in_features
    B = recs.n_att.shape[0]
    n_att = int(recs.n_att.sum())
    # The kernel leaves the records past a row's own attempts unwritten.
    own = (torch.arange(recs.rec.shape[0], device=recs.rec.device)[:, None]
           < recs.n_att[None, :])
    n_acc = int(torch.where(own, recs.rec[:, 2, :], 0.0).sum())
    n_par = sum(p.numel() for p in params.parameters())
    if kind == "bwd":
        n = 18 * n_acc
        nbytes = 4 * (B * T * D + n_att * (3 + 8 * D) + 2 * n_par + B * D)
        return n * ev[0], n * ev[1], nbytes
    n = 2 * B + 6 * n_att
    fp32 = n * ev[0] + n_att * D * 80 + n_acc * T * 20
    nbytes = 4 * (B * D + T + n_par + B * T * D)
    if kind == "fwd":
        nbytes += 4 * n_att * (3 + 8 * D)
    return fp32, n * ev[1], nbytes


def node_counts(ev, vjp, n_params, n_noise, B, D, recs, kind):
    """(FP32, SFU, bytes) of a batch-shared node kernel call: ``fwd`` (2 +
    6 per attempt field evaluations, the step arithmetic and the records)
    or ``bwd`` (6 field VJPs per accepted attempt: stage 7's cotangent is
    zero, since b[6] = 0); ``ev`` and ``vjp`` are (FP32, SFU) of one
    evaluation and one VJP of the whole batch."""
    N = B * D
    n_att = int(recs.misc[0])
    n_acc = int(recs.tda[:n_att, 1].sum())
    rec_floats = n_att * (4 + 8 * N) + 4
    if kind == "fwd":
        n = 2 + 6 * n_att
        return (n * ev[0] + N * (80 * n_att + 20), n * ev[1],
                4 * (2 * N + n_params + n_noise + rec_floats))
    n = 6 * n_acc
    return (n * vjp[0] + N * 100 * n_acc, n * vjp[1],
            4 * (2 * N + 2 * n_params + n_noise + rec_floats))


def logistic_counts(B, D, K):
    """(evaluation, VJP, parameter count) of the logistic-mixer field: two
    sigmoids per (b, l) and the (B, L) x (L, D) projection; the VJP needs
    the sigmoids again and two products, phibar = w W and gW += w^T phi,
    but not the projection itself."""
    L = D * K
    ev = (B * L * (3 + 2 * SIG[0]) + 2 * B * D * L + B * D,
          B * L * 2 * SIG[1])
    vjp = (B * L * (17 + 2 * SIG[0]) + 4 * B * D * L, B * L * 2 * SIG[1])
    return ev, vjp, 2 * L + D * L + D


def ferro_counts(B, D, H, K, noisy):
    """(evaluation, VJP, parameter count) of the two-layer ferro field:
    B (H D K + D H K) terms of a sigmoid, a tanh and about 16 FP32
    operations; the VJP needs each term's value and five gradients, all
    from one sigmoid and one tanh."""
    terms = B * 2 * H * D * K
    per = 16 + SIG[0] + TANH[0] + int(noisy)
    sfu = SIG[1] + TANH[1]
    ev = (terms * per + B * (D + H) * (SIG[0] + TANH[0]),
          terms * sfu + B * (D + H) * (SIG[1] + TANH[1]))
    link = B * (D + H)
    vjp = (terms * (per + 30) + link * (TANH[0] + 3),
           terms * sfu + link * TANH[1])
    return ev, vjp, 10 * H * D * K


def bspline_counts(n_knots=12, order=3):
    """(FP32 per point, FP32 per feature, SFU per feature) of the degree-
    ``order`` B-spline columns of one value on its feature's knots, counted
    as ``kuramoto_counts`` counts them: x - g_j for each knot, the order-0
    indicators (a compare a knot, a subtract an interval), per level k the
    weights w_j = (x - g_j) r_jk and per term w_j B_j + (1 - w_j+1) B_j+1
    (4); the reciprocals r_jk = 1 / (g_j+k - g_j) once a feature."""
    n_w = sum(n_knots - k for k in range(1, order + 1))
    n_terms = sum(n_knots - 1 - k for k in range(1, order + 1))
    per = n_knots + n_knots + (n_knots - 1) + n_w + 4 * n_terms
    return per, n_w * (1 + DIV[0]), n_w * DIV[1]


def mlp_counts(B, D, K, H, recs, kind, C=8, n_knots=12):
    """(FP32, SFU, bytes) of a B.6 kernel call ('mlp' field), each value
    the function needs counted once.  An evaluation: the layer norm and
    tanh bound (13 a value, a reciprocal square root a row), the mixer's
    two sigmoids and silu(phi) a (b, l), the B-spline columns of the B L
    layer-1 and B H layer-2 inputs, the two layers' products 2 B H n (1 +
    C), silu(y1) and silu(y2), the output product and the eff scale.  A VJP
    repeats all but the output product, then: t = w W (2 B D H), y2bar
    (6 a value), gW and gbo, geff (2 B H + 2 B D); per layer the weight
    gradients and the input cotangent, two products of 2 B H n (1 + C)
    each, the analytic derivative (4 a column) with silu' and the
    combination; the mixer's cotangent (6), ga and gb (4), the K-sum
    (2 B L) and the layer-norm backward (15 a value).  The knot
    reciprocals count once a feature; the grids get no gradient."""
    L = D * K
    per, recip, recip_sfu = bspline_counts(n_knots)
    hidden = (B * D * (13 + TANH[0]) + B * DIV[0]
              + B * L * (3 + 2 * SIG[0] + 1 + SIG[0] + per)
              + 2 * B * H * L * (1 + C) + B * H * (1 + SIG[0] + per)
              + 2 * B * H * H * (1 + C) + B * H * (1 + SIG[0]),
              B * D * TANH[1] + B * DIV[1] + B * L * 3 * SIG[1]
              + 2 * B * H * SIG[1])
    ev = (hidden[0] + 2 * B * D * H + 2 * B * D, hidden[1])
    layer_vjp = sum(4 * B * H * n * (1 + C) + B * n * (4 * C + 4 + 2 * C)
                    for n in (H, L))
    vjp = (hidden[0] + 4 * B * D * H + 6 * B * H + B * D + D * H
           + 2 * B * H + 2 * B * D + layer_vjp + B * L * (6 + 4 + 2)
           + 15 * B * D, hidden[1])
    grids = (L + H) * n_knots
    n_par = (2 * D + 2 * L + grids + H * L * (1 + C) + H * H * (1 + C)
             + D * H + D + 1)
    fp32, sfu, nbytes = node_counts(ev, vjp, n_par, 0, B, D, recs, kind)
    if kind == "bwd":
        nbytes -= 4 * grids                # no gradient of the grids
    return (fp32 + (L + H) * recip, sfu + (L + H) * recip_sfu, nbytes)


def check_training_kernels(params, spec, x0s, ts, targets):
    """Phase 6 at one batch: returns (forward max |diff|, shared-mesh
    relative gradient error, x0bar relative error, own-mesh cosine, the
    kernel's records, shared-mesh max |diff| of the gradients)."""
    from fetode_tpu_torch.ops import kanfet_adjoint as KA

    B = x0s.shape[0]
    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    with torch.no_grad():
        out_k, rec_k = KA.kanfet_adjoint_fwd(params, spec.kan, x0s, ts, **kw)
        torch.cuda.synchronize()
        out_p, _ = KA.record_attempts_reference(params, spec.kan, x0s, ts,
                                                **kw)
    yk, yp = out_k.cpu().numpy(), out_p.cpu().numpy()
    if not (np.isfinite(yk).all() and np.isfinite(yp).all()):
        fail(f"B={B}: non-finite training forward output")
    fwd_err = float(np.abs(yk - yp).max())
    if not np.allclose(yk, yp, rtol=TOL, atol=TOL):
        fail(f"B={B}: training forward kernel disagrees with plain "
             f"(max |diff| {fwd_err:.3e})")

    # The backward on the kernel's own records, against autograd of the
    # plain replay of the same records.
    ybar = 2.0 * (out_k - targets) / out_k.numel()
    g_k, xb_k = KA.kanfet_adjoint_bwd(params, spec.kan, x0s, ts, rec_k, ybar)
    g_p, xb_p = KA.replay_vjp_reference(params, spec.kan, x0s, ts, rec_k,
                                        ybar)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in g_k):
        fail(f"B={B}: non-finite kernel gradients")
    g_err, x_err = rel_err(flat(g_k), flat(g_p)), rel_err(xb_k, xb_p)
    if not (g_err < GRAD_TOL and x_err < GRAD_TOL):
        fail(f"B={B}: backward kernel vs plain replay on the kernel's mesh: "
             f"param grads rel {g_err:.3e}, x0bar rel {x_err:.3e}")

    # Full gradients, each solve on its own mesh.
    def full(solve):
        weights = KA.train_weights(params)
        loss = torch.mean((solve(params, spec.kan, x0s, ts, **kw)
                           - targets) ** 2)
        return flat(torch.autograd.grad(loss, weights))

    gk, gp = full(KA.kanfet_solve_train), full(KA.kanfet_solve_train_reference)
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    if not cos > COS_MIN:
        fail(f"B={B}: own-mesh gradient cosine {cos:.6f}")
    print(f"training kernels vs plain, B={B}: forward max |diff| "
          f"{fwd_err:.3e}; backward on the kernel's mesh: grads rel "
          f"{g_err:.3e}, x0bar rel {x_err:.3e}; own-mesh cosine {cos:.7f}; "
          f"attempts {int(rec_k.n_att.min())}..{int(rec_k.n_att.max())}")
    return fwd_err, g_err, x_err, cos, rec_k, max_abs(flat(g_k), flat(g_p))


def time_training(params, spec, x0s, ts, targets, smi):
    """Phase 8 at one batch: CUDA-event ms of forward, backward, Adam and
    a whole step, kernels and plain."""
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    B = x0s.shape[0]
    res = {}
    for name, solve, reps in (("kernel", KA.kanfet_solve_train, 5),
                              ("plain", KA.kanfet_solve_train_reference, 1)):
        p = copy.deepcopy(params)
        weights = KA.train_weights(p)
        fwd = cuda_ms(lambda: solve(p, spec.kan, x0s, ts, **kw), reps)
        out = solve(p, spec.kan, x0s, ts, **kw)
        ybar = 2.0 * (out.detach() - targets) / out.numel()
        bwd = cuda_ms(lambda: torch.autograd.grad(out, weights, ybar,
                                                  retain_graph=True), reps)

        def loss_fn(q, x, tgt):
            return torch.mean((solve(q, spec.kan, x, ts, **kw) - tgt) ** 2)

        # lr = 0: Adam does all its work, but every timed step solves
        # with the same parameters, on the same step mesh as fwd and bwd.
        state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                             grad_clip=1.0))
        step = make_train_step(loss_fn)
        whole = cuda_ms(lambda: step(state, x0s, targets), reps)
        adam = cuda_ms(state.opt.step, 20)
        res[name] = dict(fwd=fwd, bwd=bwd, adam=adam, step=whole)
        print(f"time B={B} {name}: forward {fwd:.3f} ms, backward "
              f"{bwd:.3f} ms, Adam+clip {adam:.3f} ms, whole step "
              f"{whole:.3f} ms ({smi})")
    return res


# ------------------------------------------------------------------- ECG


def final_state_plain(field, weights, opts):
    """The plain versions of a final-state kernel pair (``ops/node_common.py``)
    as a case's ``plain_fwd``, ``plain_bwd`` and ``plain_solve``."""
    from fetode_tpu_torch.ops import node_common as NC

    return dict(
        plain_fwd=lambda h0: NC.record_solve_reference(field, h0, **opts),
        plain_bwd=lambda h0, recs, hbar: NC.replay_vjp_reference(
            field, weights, h0, recs, hbar),
        plain_solve=lambda h0: NC.solve_reference(field, h0, **opts))


def logistic_case(params, spec):
    """The logistic-mixer kernels of a ``KanFetNODE`` model as closures,
    with their plain field, weights and operation counts."""
    from fetode_tpu_torch.ops import logistic_node as LN

    w = (params.field_mixer.a, params.field_mixer.b, params.proj_w,
         params.proj_b)
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    D, K = spec.latent_dim, spec.num_basis

    def counts(B, recs, kind):
        ev, vjp, n_par = logistic_counts(B, D, K)
        return node_counts(ev, vjp, n_par, 0, B, D, recs, kind)

    return dict(
        name="logistic_node",
        fwd=lambda h0, record=True: LN.logistic_node_fwd(*w, h0,
                                                         record=record,
                                                         **opts),
        bwd=lambda h0, recs, hbar: LN.logistic_node_bwd(*w, h0, recs, hbar),
        solve=lambda h0: LN.logistic_node_solve(params, h0, spec),
        weights=w, counts=counts,
        **final_state_plain(LN.logistic_field(*w), w, opts))


def ferro_case(params, spec, noise):
    """The ferro kernels of a ``KanFetMLPNODE`` model, with frozen noise
    (for one batch size) or None."""
    from fetode_tpu_torch.ops import ferro_node as FN

    cfg = FN.ferro_node_config(spec)
    fc1, fc2 = params.fc1, params.fc2
    w = [getattr(p, n) for p in (fc1, fc2)
         for n in ("k", "ec", "ps", "bias", "coef")]
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    D, H, K = spec.latent_dim, spec.ode_hidden, spec.num_basis

    def counts(B, recs, kind):
        ev, vjp, n_par = ferro_counts(B, D, H, K, noise is not None)
        n_noise = 0 if noise is None else sum(n.numel() for n in noise)
        return node_counts(ev, vjp, n_par, n_noise, B, D, recs, kind)

    return dict(
        name="ferro_node" + ("" if noise is None else " noisy"),
        fwd=lambda h0, record=True: FN.ferro_node_fwd(fc1, fc2, h0, cfg,
                                                      noise=noise,
                                                      record=record),
        bwd=lambda h0, recs, hbar: FN.ferro_node_bwd(fc1, fc2, h0, recs,
                                                     hbar, cfg, noise=noise),
        solve=lambda h0: FN.ferro_node_solve(fc1, fc2, h0, spec,
                                             noise=noise),
        weights=w, counts=counts,
        **final_state_plain(FN.ferro_field(fc1, fc2, cfg, noise), w, opts))


def check_node_kernels(case, h0, hbar, backward=True):
    """Phases 9-10, 14 and 24 at one batch: both forward kernels against the
    plain recording solve (values and attempts) and, with ``backward``,
    the backward kernel against autograd of the plain replay on the
    kernel's records, and full gradients on own meshes."""
    label = f"{case['name']} B={h0.shape[0]}"
    with torch.no_grad():
        out_k, rec_k = case["fwd"](h0)
        out_n, _ = case["fwd"](h0, record=False)
        torch.cuda.synchronize()
        out_p, rec_p = case["plain_fwd"](h0)
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_n).all()
            and torch.isfinite(out_p).all()):
        fail(f"{label}: non-finite forward output")
    fwd_err, norec_err = max_abs(out_k, out_p), max_abs(out_n, out_p)
    for what, out, err in (("with records", out_k, fwd_err),
                           ("without records", out_n, norec_err)):
        if not torch.allclose(out, out_p, rtol=TOL, atol=TOL):
            fail(f"{label}: forward kernel {what} disagrees with plain "
                 f"(max |diff| {err:.3e})")
    n_k, n_p = int(rec_k.misc[0]), int(rec_p.misc[0])
    if n_k != n_p:
        fail(f"{label}: {n_k} attempts in the kernel, {n_p} in plain")
    res = dict(fwd_err=max(fwd_err, norec_err))
    line = (f"{label} vs plain: forward max |diff| {fwd_err:.3e} (without "
            f"records {norec_err:.3e}); attempts {n_k} (accepted "
            f"{int(rec_k.tda[:n_k, 1].sum())}) as plain")
    if backward:
        g_k, hb_k = case["bwd"](h0, rec_k, hbar)
        g_p, hb_p = case["plain_bwd"](h0, rec_k, hbar)
        torch.cuda.synchronize()
        if not (all(torch.isfinite(g).all() for g in g_k)
                and torch.isfinite(hb_k).all()):
            fail(f"{label}: non-finite kernel gradients")
        g_rel, h_rel = rel_err(flat(g_k), flat(g_p)), rel_err(hb_k, hb_p)
        if not (g_rel < GRAD_TOL and h_rel < GRAD_TOL):
            fail(f"{label}: backward kernel vs plain replay on the kernel's "
                 f"mesh: param grads rel {g_rel:.3e}, h0bar rel {h_rel:.3e}")

        def full(solve):
            return flat(torch.autograd.grad(torch.sum(solve(h0) * hbar),
                                            case["weights"]))

        gk, gp = full(case["solve"]), full(case["plain_solve"])
        cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
        if not cos > COS_MIN:
            fail(f"{label}: own-mesh gradient cosine {cos:.6f}")
        res.update(g_rel=g_rel, h_rel=h_rel, cos=cos,
                   g_abs=max(max_abs(flat(g_k), flat(g_p)),
                             max_abs(hb_k, hb_p)))
        line += (f"; backward on the kernel's mesh: grads rel {g_rel:.3e}, "
                 f"h0bar rel {h_rel:.3e}; own-mesh cosine {cos:.7f}")
    print(line)
    return res


def time_node_kernels(case, h0, hbar, smi, plain=True):
    """Phases 13, 18 and 27 at one batch: CUDA-event ms of the forward kernel
    with and without records, the backward kernel, and (``plain``) the
    plain recording solve and the plain replay's autograd."""
    B = h0.shape[0]
    with torch.no_grad():
        _, recs = case["fwd"](h0)
    res = dict(recs=recs,
               fwd=cuda_ms(lambda: case["fwd"](h0), 20),
               fwd_norec=cuda_ms(lambda: case["fwd"](h0, record=False), 20),
               bwd=cuda_ms(lambda: case["bwd"](h0, recs, hbar), 20))
    line = (f"time {case['name']} B={B}: forward {res['fwd']:.4f} ms "
            f"(without records {res['fwd_norec']:.4f}), backward "
            f"{res['bwd']:.4f} ms")
    if plain:
        with torch.no_grad():
            res["plain_fwd"] = cuda_ms(lambda: case["plain_fwd"](h0), 1)
        res["plain_bwd"] = cuda_ms(lambda: case["plain_bwd"](h0, recs, hbar),
                                   1)
        line += (f"; plain forward {res['plain_fwd']:.3f} ms, plain "
                 f"backward {res['plain_bwd']:.3f} ms")
    for kind in ("fwd", "bwd"):
        res[f"bound_{kind}"] = bound(*case["counts"](B, recs, kind))
    print(f"{line}; bounds fwd {res['bound_fwd'][0]:.5f} ms "
          f"({res['bound_fwd'][2]}), bwd {res['bound_bwd'][0]:.5f} ms "
          f"({res['bound_bwd'][2]}); attempts {int(recs.misc[0])} ({smi})")
    return res


def ecg_step_fn(apply, params, spec, x, y, mode):
    """One ECG training step (forward, cross-entropy, backward, clip and
    AdamW) with the latent solve in ``mode``, as a closure; learning rate
    0, so every call solves with the same parameters."""
    from fetode_tpu_torch.train.ecg_driver import cross_entropy
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    p = copy.deepcopy(params)
    state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                         kind="adamw", weight_decay=1e-4,
                                         grad_clip=1.0))
    s = spec._replace(solver_mode=mode)
    step = make_train_step(lambda q, xb, yb: cross_entropy(apply(q, s, xb),
                                                           yb))
    return lambda: step(state, x, y)


def device_trace(fn, n):
    """torch.profiler over ``n`` calls of ``fn`` after a warm one: (wall ms
    per call, the trace's kernel and copy events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall, [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def profile_ms(fn, n=5):
    """(wall ms per call, device-busy ms per call, the union of the kernels'
    and copies' intervals in the trace, and the three kernels with the
    most device time as (name, ms per call)) over ``n`` profiled calls."""
    wall, device = device_trace(fn, n)
    busy, end = 0.0, -1.0
    for t, d in sorted((float(e["ts"]), float(e["dur"])) for e in device):
        busy += max(0.0, t + d - max(t, end))
        end = max(end, t + d)
    per_kernel = {}
    for e in device:
        if e["cat"] == "kernel":
            per_kernel[e["name"]] = per_kernel.get(e["name"], 0.0) + e["dur"]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    return wall, busy / 1e3 / n, [(k[:60], v / 1e3 / n) for k, v in top]


def queued_ms(fn, n=20, windows=3):
    """The device time per call of everything ``fn`` launches, back to back
    on a full queue: ``torch.cuda._sleep`` holds the stream busy while the
    host enqueues the ``n`` calls, so the CUDA events around them time the
    device's work, not the host's launch overhead.  The sleep starts at
    twice the enqueue time of a calibration window; a window whose sleep
    ended before the host had enqueued every call is taken again with a
    sleep twice as long.  Median of ``windows``; no profiler."""
    def ev():
        return torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    cycles = int(2.0 * (time.perf_counter() - t0 + 1e-3) * 2.0e9)
    torch.cuda.synchronize()
    per_call = []
    while len(per_call) < windows:
        mark, start, stop = ev(), ev(), ev()
        mark.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        if mark.elapsed_time(start) > enqueue_ms:
            per_call.append(start.elapsed_time(stop) / n)
        elif cycles > 1e11:
            fail(f"queued_ms: the host's enqueue of {n} calls outlasted a "
                 f"{cycles:.3g}-cycle sleep")
        else:
            cycles *= 2
    return float(np.median(per_call))


def check_served(sv, fn, reqs, served, label):
    """Phases 12 and 17: each request's output through the bundle equals
    direct calls of ``fn`` on the same padded batches (padding rows are
    copies of a chunk's last row, as ``Servable.predict`` pads)."""
    with torch.no_grad():
        for b, x in reqs.items():
            want = []
            for off in range(0, b, sv.buckets[-1]):
                chunk = x[off:off + sv.buckets[-1]]
                take = chunk.shape[0]
                bucket = next(k for k in sv.buckets if k >= take)
                padded = torch.cat([chunk, chunk[-1:].expand(
                    (bucket - take,) + tuple(chunk.shape[1:]))])
                want.append(fn(sv.params, padded)[:take])
            want = torch.cat(want)
            if served[b].shape != want.shape or \
                    not torch.isfinite(served[b]).all() or \
                    not torch.equal(served[b], want):
                fail(f"{label} request B={b}: served output differs from "
                     "direct kernel calls on the padded batch")


def serve_lines(label, bench, predict, smi, n=5):
    """Phases 17 and 26: for each bucket of a serve bench, its p50 / p99
    and the device-busy share of ``predict(bucket)`` under the profiler,
    one line a bucket with the card's name and power limit."""
    for row in bench:
        b = row["batch"]
        wall, busy, top = profile_ms(lambda: predict(b), n)
        print(f"  {label} bucket {b}: p50 {row['p50_ms']:.4f} ms, p99 "
              f"{row['p99_ms']:.4f} ms, window p50s "
              f"{['%.4f' % w for w in row['window_p50_ms']]}; profiled: wall "
              f"{wall:.4f} ms, device busy {busy:.4f} ms "
              f"({100 * busy / wall:.1f}%), top "
              f"{[(k, round(v, 4)) for k, v in top]} ({smi})")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def ecg_phases(device, smi):
    """Phases 9-13, the ECG slice: returns the kernel checks, the timings
    and the kernels' launches on the training and serving paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import ferro_node as FN
    from fetode_tpu_torch.ops import logistic_node as LN
    from fetode_tpu_torch.serve import load_servable

    # ---- 9-10. ECG kernels against plain, at ECGPreset's width
    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])        # 96 series of 96
    rng_e = np.random.default_rng(2)
    xs = {b: torch.from_numpy((series[np.arange(b) % len(series)] + 0.05
                               * rng_e.standard_normal((b, series.shape[1]))
                               ).astype(np.float32)).to(device)
          for b in ECG_CHECKS}
    lspec = M.KanFetNODESpec(num_basis=12)
    fspec = M.KanFetMLPNODESpec(num_basis=12)
    lparams = M.kanfet_node_init(torch.Generator().manual_seed(0), lspec,
                                 device=device)
    fparams = M.kanfet_mlp_node_init(torch.Generator().manual_seed(0), fspec,
                                     device=device)
    with torch.no_grad():
        lh0 = {b: x @ lparams.encoder_w.T + lparams.encoder_b
               for b, x in xs.items()}
        fh0 = {b: x @ fparams.encoder_w.T + fparams.encoder_b
               for b, x in xs.items()}
    hbars = {b: torch.from_numpy(rng_e.standard_normal(
        (b, lspec.latent_dim)).astype(np.float32)).to(device)
        for b in ECG_CHECKS}
    lcase = logistic_case(lparams, lspec)
    # Every batch the main path gives each kernel: the training batch,
    # the accuracy evals' 64 and 32, and (logistic) the serving buckets.
    ncases = {b: ferro_case(fparams, fspec, FN.frozen_solve_noise(
        torch.Generator().manual_seed(3), b, fspec.fc1_cfg, fspec.fc2_cfg,
        noise_std=0.2, device=device)) for b in (8, 32, 64)}
    fcase, ncase = ferro_case(fparams, fspec, None), ncases[8]
    ecg_checks = {("logistic", b): check_node_kernels(lcase, lh0[b], hbars[b])
                  for b in ECG_CHECKS}
    for b in (8, 32, 64):
        ecg_checks[("ferro", b)] = check_node_kernels(fcase, fh0[b], hbars[b])
        ecg_checks[("ferro noisy", b)] = check_node_kernels(
            ncases[b], fh0[b], hbars[b])

    # ---- 11. the ECG training slice, through the CLI
    ecg_kernels = (LN.logistic_node_fwd, LN.logistic_node_bwd,
                   FN.ferro_node_fwd, FN.ferro_node_bwd)
    ecg_launches = [0, 0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        for model, extra in (("kanfet_node", []), ("kanfet_mlp_node", []),
                             ("kanfet_mlp_node", ["--noise_std", "0.2"])):
            for f in ecg_kernels:
                f.launches = 0
            res = cli.main(["ecg", "--device", "cuda", "--solver_mode",
                            "pallas", "--epochs", "3", "--model", model,
                            *extra, "--out-dir", tmp])
            torch.cuda.synchronize()
            ecg_counts = [f.launches for f in ecg_kernels]
            own = (ecg_counts[:2] if model == "kanfet_node"
                   else ecg_counts[2:])
            label = " ".join([model] + extra)
            if min(own) < 1:
                fail(f"cli ecg --model {label}: kernel launches {ecg_counts}")
            if not np.isfinite(res["loss_curve"]).all():
                fail(f"cli ecg --model {label}: non-finite losses "
                     f"{res['loss_curve']}")
            ecg_launches = [a + b for a, b in zip(ecg_launches, ecg_counts)]
            print(f"cli ecg --model {label} (3 epochs, pallas): losses "
                  f"{[round(v, 4) for v in res['loss_curve']]}, test acc "
                  f"{res['test_acc_curve']}, best {res['best_test_acc']}; "
                  f"{res['wall_seconds']:.2f} s; launches (logistic fwd, "
                  f"bwd, ferro fwd, bwd) {ecg_counts} ({smi})")

    # ---- 12. the ECG serving slice, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["serve", "--source", "ecg", "--solver_mode", "pallas",
                "--device", "cuda", "--buckets", "8,64,256",
                "--out-dir", tmp]
        for f in ecg_kernels:
            f.launches = 0
        sresult = cli.main(argv)
        cfg = make_config("serve", cli._parse(argv)[1])
        sparams, sfn, _ = cli.ecg_serving(cfg, device)
        sv = load_servable(sresult["bundle"], sfn, sparams)
        reqs = {b: torch.from_numpy(np.resize(series, (b, cfg.t_len))).to(
            device) for b in (1, 30, 300)}
        served = {b: sv.predict(x) for b, x in reqs.items()}
        torch.cuda.synchronize()
        ecg_counts = [f.launches for f in ecg_kernels]
        if ecg_counts[0] < 1:
            fail("the ECG serving path launched no logistic_node kernel")
        ecg_launches = [a + b for a, b in zip(ecg_launches, ecg_counts)]
        check_served(sv, sfn, reqs, served, "ECG")
        wall, busy, top = profile_ms(lambda: sv.predict(xs[8]).cpu())
    print(f"ECG served B=1/30/300 through the bundle = direct kernel calls "
          f"on the padded batches; launches {ecg_counts}")
    print(f"ECG serve profile, bucket 8: wall {wall:.4f} ms, device busy "
          f"{busy:.4f} ms ({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    for row in sresult["bench"]:
        print(f"  ECG serve bucket {row['batch']}: p50 {row['p50_ms']:.4f} "
              f"ms, p99 {row['p99_ms']:.4f} ms, window p50s "
              f"{['%.4f' % w for w in row['window_p50_ms']]} ({smi})")

    # ---- 13. ECG timing: kernels and plain, a training step
    ecg_times = {("logistic", b): time_node_kernels(lcase, lh0[b], hbars[b],
                                                    smi)
                 for b in ECG_BATCHES}
    ecg_times[("ferro", 8)] = time_node_kernels(fcase, fh0[8], hbars[8], smi)
    ecg_times[("ferro noisy", 8)] = time_node_kernels(ncase, fh0[8],
                                                      hbars[8], smi,
                                                      plain=False)
    ecg_times[("ferro", 64)] = time_node_kernels(fcase, fh0[64], hbars[64],
                                                 smi, plain=False)
    y8 = torch.from_numpy(data[1][:8]).long().to(device)
    for name, apply, params_m, spec_m in (
            ("kanfet_node", M.kanfet_node_apply, lparams, lspec),
            ("kanfet_mlp_node", M.kanfet_mlp_node_apply, fparams, fspec)):
        step_k = ecg_step_fn(apply, params_m, spec_m, xs[8], y8, "pallas")
        kernel = cuda_ms(step_k, 10)
        eager = cuda_ms(ecg_step_fn(apply, params_m, spec_m, xs[8], y8,
                                    "scan"), 1)
        wall, busy, top = profile_ms(step_k)
        print(f"time ECG training step {name} B=8: kernels {kernel:.4f} ms, "
              f"eager scan solve {eager:.3f} ms; profiled: wall {wall:.4f} "
              f"ms, device busy {busy:.4f} ms ({100 * busy / wall:.1f}%), "
              f"top {[(k, round(v, 4)) for k, v in top]} ({smi})")

    return ecg_checks, ecg_times, ecg_launches


# --------------------------------------------------------------- forecasting


def ode_dyn_counts(B, D, H, ts, recs, kind):
    """(FP32, SFU, bytes) of a latent trajectory kernel call: ``fwd`` (2 +
    6 per attempt field evaluations of three products and 2 B H tanhs,
    the step arithmetic, the dense output and, with records, the
    records) or ``bwd`` (per accepted attempt 6 field VJPs, 7 when an
    output time falls in its window: the two hidden layers again and six
    products)."""
    N = B * D
    n_att = int(recs.misc[0])
    tda = recs.tda[:n_att].cpu().numpy()
    tsn = ts.cpu().numpy()
    acc = [(t, dt) for dt, a, t, _ in tda if a > 0.5]
    n_par = H * (D + 1) + H + H * H + H + D * H + D
    ev = (2 * B * (D * H + H * H + H * D) + 2 * B * H * TANH[0],
          2 * B * H * TANH[1])
    rec_floats = n_att * (4 + 8 * N) + 4
    if kind == "fwd":
        n = 2 + 6 * n_att
        return (n * ev[0] + N * (80 * n_att + 40 * len(tsn)), n * ev[1],
                4 * (N + len(tsn) + n_par + len(tsn) * N + rec_floats))
    n_vjp = sum(6 + int(any(t < v <= t + dt for v in tsn)) for t, dt in acc)
    vjp = (2 * B * (D * H + H * H) + 4 * B * (2 * D * H + H * H)
           + 2 * B * H * (TANH[0] + 3), 2 * B * H * TANH[1])
    return (n_vjp * vjp[0] + N * 100 * len(acc), n_vjp * vjp[1],
            4 * (len(tsn) * N + len(tsn) + rec_floats + 2 * n_par + N))


def ddpm_counts(rows, P, H, T):
    """(FP32, SFU, bytes) of one whole-chain call: per row and step the
    three products, 2 H SiLUs (a sigmoid each) and the update; each table
    read once, the samples written once."""
    per = 2 * P * H + 2 * H * H + 2 * H * P + 2 * H * (SIG[0] + 1) + 6 * P
    nbytes = 4 * (2 * rows * P + rows * H + T * H + T * rows * P + 3 * T
                  + 2 * P * H + H * H + H + P)
    return T * rows * per, T * rows * 2 * H * SIG[1], nbytes


def forecast_windows():
    """The full-width windows of the synthetic series that ``cli ett``
    falls back to, all splits, as one (M, 96, 7) array."""
    from fetode_tpu_torch.data.timeseries import synthetic_series
    from fetode_tpu_torch.train.forecast_driver import (
        ForecastRun,
        prepare_windows,
    )

    X, y = synthetic_series(n=2000, n_features=6)
    windows, _, _ = prepare_windows(X, y, ForecastRun())
    return np.concatenate([windows[k][0] for k in ("train", "val",
                                                   "test")])


def ode_dyn_case(layers, ts):
    """The latent trajectory kernels of a forecaster's field MLP as
    closures, with their plain versions (the trajectory twins of
    ``ops/node_common.py``), weights and operation counts."""
    from fetode_tpu_torch.ops import node_common as NC
    from fetode_tpu_torch.ops import ode_dyn as OD

    w = OD.layer_weights(layers)
    field = OD.ode_dyn_field(*w)
    D, H = w[4].shape[0], w[2].shape[0]
    return dict(
        name="ode_dyn",
        fwd=lambda z0, record=True: OD.ode_dyn_fwd(w, z0, ts, record=record),
        bwd=lambda z0, recs, ct: OD.ode_dyn_bwd(w, z0, ts, recs, ct),
        solve=lambda z0: OD.ode_dyn_solve(layers, z0, ts),
        plain_fwd=lambda z0: NC.record_solve_traj_reference(field, z0, ts),
        plain_bwd=lambda z0, recs, ct: NC.replay_traj_vjp_reference(
            field, w, z0, ts, recs, ct),
        plain_solve=lambda z0: NC.solve_traj_reference(field, z0, ts),
        weights=w,
        counts=lambda B, recs, kind: ode_dyn_counts(B, D, H, ts, recs, kind))


def ddpm_case(dparams, dspec, sched, x, seed):
    """Phase 15's tables for the windows ``x`` at 10 samples: the kernel's
    sampler inputs and the plain chain's arguments on the same draws."""
    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.nn import diffusion as TD

    S, B, P, T = 10, x.shape[0], dspec.pred_len, sched.T
    head = dparams["eps_head"]
    g = torch.Generator(device=x.device).manual_seed(seed)
    with torch.no_grad():
        cond = F._cond(dparams, dspec, x, torch.arange(
            P, dtype=torch.float32, device=x.device))
        y0 = torch.randn((S, B, P), generator=g, device=x.device)
        noise = torch.randn((S, T, B, P), generator=g, device=x.device)
        cond_h, temb_h, w1y = TD.eps_head_tables(head, dspec.eps_cfg, sched,
                                                 cond)
    chain = (y0.reshape(S * B, P), cond_h.repeat(S, 1), temb_h,
             noise.transpose(0, 1).reshape(T, S * B, P),
             TD.chain_coefficients(sched), w1y, head[1].w.detach(),
             head[1].b.detach(), head[2].w.detach(), head[2].b.detach())
    return dict(cond=cond, y0=y0, noise=noise, chain=chain)


def forecast_phases(device, smi):
    """Phases 14-18, the ETT forecasting slice: returns the kernel checks,
    the timings and the kernels' launches on the training and serving
    paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.nn import diffusion as TD
    from fetode_tpu_torch.nn.mlp import mlp_apply
    from fetode_tpu_torch.ops import ddpm as DD
    from fetode_tpu_torch.ops import ode_dyn as OD
    from fetode_tpu_torch.serve import load_servable
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    wins = forecast_windows()
    rng_f = np.random.default_rng(4)

    def xs(b, off=0):
        return torch.from_numpy(wins[(off + np.arange(b)) % len(wins)]).to(
            device)

    # ---- 14. B.7 against plain, at ETTPreset's width
    pspec = F.LatentODEForecasterSpec(num_features=wins.shape[2])
    pparams = F.latent_ode_forecaster_init(torch.Generator().manual_seed(0),
                                           pspec, device=device)
    D = pspec.latent_dim
    ts = torch.arange(pspec.pred_len, dtype=torch.float32, device=device)
    ocase = ode_dyn_case(pparams["dynamics"], ts)
    with torch.no_grad():
        z0s = {b: mlp_apply(pparams["encoder"], pspec.enc,
                            xs(b, 37 * b).reshape(b, -1))
               for b in ODE_CHECKS}
    cts = {b: torch.from_numpy(rng_f.standard_normal(
        (len(ts), b, D)).astype(np.float32)).to(device) for b in ODE_CHECKS}
    ode_checks = {b: check_node_kernels(ocase, z0s[b], cts[b],
                                        backward=b in ODE_BACKWARD)
                  for b in ODE_CHECKS}

    # ---- 15. B.9 against plain, at the eps-head's width
    dspec = F.DiffusionForecasterSpec(num_features=wins.shape[2], diff_T=200)
    dparams = F.diffusion_forecaster_init(torch.Generator().manual_seed(0),
                                          dspec, device=device)
    sched = TD.make_schedule(dspec.diff_T, device=device)
    ddpm_cases = {r: ddpm_case(dparams, dspec, sched, xs(r // 10, 11 * r), r)
                  for r in DDPM_ROWS}
    ddpm_errs = {}
    for r, c in ddpm_cases.items():
        got = DD.eps_head_sample(dparams["eps_head"], dspec.eps_cfg, sched,
                                 c["cond"], n_samples=10, y0=c["y0"],
                                 noise=c["noise"])
        torch.cuda.synchronize()
        with torch.no_grad():
            want = DD.ddpm_chain_reference(*c["chain"])
        got = got.reshape(r, dspec.pred_len)
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"ddpm rows={r}: non-finite samples")
        ddpm_errs[r] = max_abs(got, want)
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            fail(f"ddpm rows={r}: chain kernel disagrees with plain (max "
                 f"|diff| {ddpm_errs[r]:.3e})")
        # the same bits twice, and rows 0 and R-1 alone as in the batch
        chain = c["chain"]
        with torch.no_grad():
            again = DD.ddpm_chain(*chain)
            alone = []
            for i in sorted({0, r - 1}):
                one = list(chain)
                one[0], one[1] = chain[0][i:i + 1], chain[1][i:i + 1]
                one[3] = chain[3][:, i:i + 1]
                alone.append(torch.equal(DD.ddpm_chain(*one), got[i:i + 1]))
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            fail(f"ddpm rows={r}: two calls of the chain kernel differ")
        if not all(alone):
            fail(f"ddpm rows={r}: rows 0 and {r - 1} alone differ from the "
                 "batch")
    print(f"ddpm chain vs plain, rows {list(DDPM_ROWS)}: max |diff| "
          f"{[float('%.3e' % e) for e in ddpm_errs.values()]}; the same bits "
          f"twice, rows 0 and R-1 alone as in the batch")

    # ---- 16. the training slice, through the CLI
    kernels = (OD.ode_dyn_fwd, OD.ode_dyn_bwd, DD.ddpm_chain)
    launches = [0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        for model in ("point", "diffusion", "kan_diffusion"):
            for f in kernels:
                f.launches = 0
            res = count_spline(f"cli ett --model {model}", lambda: cli.main(
                ["ett", "--model", model, "--device", "cuda",
                 "--solver_mode", "pallas", "--epochs", "2",
                 "--out-dir", tmp]))
            torch.cuda.synchronize()
            counts = [f.launches for f in kernels]
            need = counts[:2] if model == "point" else counts
            if min(need) < 1:
                fail(f"cli ett --model {model}: kernel launches {counts}")
            curves = res["train_curve"] + res["val_curve"] + [
                res["test_mse"]]
            if not np.isfinite(curves).all():
                fail(f"cli ett --model {model}: non-finite losses {curves}")
            launches = [a + b for a, b in zip(launches, counts)]
            print(f"cli ett --model {model} (2 epochs, pallas): train "
                  f"{[round(v, 5) for v in res['train_curve']]}, val "
                  f"{[round(v, 5) for v in res['val_curve']]}, test MSE "
                  f"{res['test_mse']:.5f}; {res['wall_seconds']:.2f} s; "
                  f"launches (ode_dyn fwd, bwd, ddpm) {counts} ({smi})")

    # ---- 17. the serving slice, through the CLI
    reqs = {b: xs(b, 5 * b) for b in (1, 30, 300)}
    serve_rows = {}
    for source in ("ett", "ddpm"):
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["serve", "--source", source, "--solver_mode", "pallas",
                    "--device", "cuda", "--buckets", "8,64,256",
                    "--out-dir", tmp]
            for f in kernels:
                f.launches = 0
            sresult = cli.main(argv)
            cfg = make_config("serve", cli._parse(argv)[1])
            sparams, sfn, _ = cli.SERVING[source](cfg, device)
            sv = load_servable(sresult["bundle"], sfn, sparams)
            served = {b: sv.predict(x) for b, x in reqs.items()}
            torch.cuda.synchronize()
            counts = [f.launches for f in kernels]
            need = counts[:1] + (counts[2:] if source == "ddpm" else [])
            if min(need) < 1:
                fail(f"serve --source {source}: kernel launches {counts}")
            launches = [a + b for a, b in zip(launches, counts)]
            check_served(sv, sfn, reqs, served, f"serve {source}")
            print(f"serve {source}: B=1/30/300 through the bundle = direct "
                  f"calls on the padded batches; launches {counts}")
            serve_lines(f"serve {source}", sresult["bench"],
                        lambda b: sv.predict(xs(b)).cpu(), smi)
        serve_rows[source] = sresult["bench"]

    # ---- 18. timing: kernels and plain, a training step of each model
    times = {("ode_dyn", b): time_node_kernels(ocase, z0s[b], cts[b], smi)
             for b in (64, 297)}
    for r in (80, 640, 970, 2560):
        chain = ddpm_cases[r]["chain"]
        t = dict(ms=cuda_ms(lambda: DD.ddpm_chain(*chain), 5),
                 bound=bound(*ddpm_counts(r, dspec.pred_len,
                                          dspec.diff_hidden, dspec.diff_T)))
        with torch.no_grad():
            t["plain"] = cuda_ms(lambda: DD.ddpm_chain_reference(*chain), 1)
        times[("ddpm", r)] = t
        tile = DD.chain_tile(r, dspec.pred_len, dspec.diff_hidden,
                             dspec.diff_T)
        print(f"time ddpm rows={r}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain']:.3f} ms; bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][2]}); tile {tile} ({smi})")

    x64, y64 = xs(64), torch.from_numpy(rng_f.standard_normal(
        (64, pspec.pred_len)).astype(np.float32)).to(device)

    def step_fn(params, loss, mode):
        p = copy.deepcopy(params)
        state = init_state(p, make_optimizer(
            0.0, params=p.parameters(), kind="adamw", weight_decay=1e-4,
            grad_clip=1.0))
        step = make_train_step(lambda q, xb, yb: loss(q, mode, xb, yb))
        return lambda: step(state, x64, y64)

    def point_loss(q, mode, xb, yb):
        return torch.mean((F.latent_ode_forecast(
            q, pspec._replace(solver_mode=mode), xb) - yb) ** 2)

    def diff_loss(q, mode, xb, yb):
        g = torch.Generator(device=device).manual_seed(0)
        return F.diffusion_forecaster_loss(
            q, dspec._replace(solver_mode=mode), sched, xb, yb, g)

    for name, params_m, loss in (("point", pparams, point_loss),
                                 ("diffusion", dparams, diff_loss)):
        step_k = step_fn(params_m, loss, "pallas")
        kernel = cuda_ms(step_k, 10)
        eager = cuda_ms(step_fn(params_m, loss, "scan"), 1)
        wall, busy, top = profile_ms(step_k)
        times[("step", name)] = dict(kernel=kernel, eager=eager, wall=wall,
                                     busy=busy)
        print(f"time ETT training step {name} B=64: kernels {kernel:.4f} "
              f"ms, eager scan solve {eager:.3f} ms; profiled: wall "
              f"{wall:.4f} ms, device busy {busy:.4f} ms "
              f"({100 * busy / wall:.1f}%), top "
              f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    return ode_checks, ddpm_errs, times, launches


# --------------------------------------------------------------- Kuramoto


def kuramoto_counts(B, H, W, steps, kind, C=10, n_logistic=8, n_knots=12,
                    order=3):
    """(FP32, SFU, bytes) of a Kuramoto kernel call, counting each value
    the function needs once.  Per site and step of a rollout: a sincosf,
    two neighbour sums (one add fewer than a site's neighbours), the
    coupling (3) and the update theta + dt omega + (dt K) coupling (3;
    dt omega and dt K are made once a call).  ``bwd`` replays the rollout and
    keeps what it made (sin, cos, the sums, the coupling), then per site
    and step: g cos and g sin (2), their neighbour sums, tbar = cos (S(g
    cos) - g S(cos)) + sin (S(g sin) - g S(sin)) (7), the update (2) and
    the omegabar and Kbar sums (3); one sincosf a site starts the walk.
    ``logits`` adds, per image and feature: x - g_j for each knot, the
    order-0 indicators from their signs (a compare a knot, a subtract an
    interval), per recursion level k the weights w_j = (x - g_j) r_jk
    with r_jk = 1 / (g_j+k - g_j), and per term w_j B_j + (1 - w_j+1)
    B_j+1 (4); SiLU; n_logistic sigmoids 2 / (1 + exp(-a (x - b))); and
    2 C operations for each of the 1 + n_coeff + n_logistic terms.  The
    reciprocals r_jk depend only on the knots: they count once a
    feature, not once an image.  Each operand is read once and each
    result written once; the head's weights count once, though every
    block reads them anew from L2."""
    HW, F = H * W, 2 * H * W
    nsum = 3 * HW - 2 * (H + W)            # adds of one lattice's sums
    step = HW * (SINCOS[0] + 3 + 3) + 2 * nsum
    roll = steps * step + HW * SINCOS[0]
    io = 4 * (B * HW + HW + 1)
    if kind == "fwd":
        return B * roll + HW + 1, 0, io + 4 * B * F
    if kind == "bwd":
        back = HW * (2 + 7 + 2 + 3) + 2 * nsum
        fp32 = B * (roll + steps * back + 3 * HW) + B * (HW + 1) + HW + 1
        return fp32, 0, io + 4 * (B * F + B * HW + HW + 1)
    n_coeff = n_knots - 1 - order
    n_w = sum(n_knots - k for k in range(1, order + 1))
    n_terms = sum(n_knots - 1 - k for k in range(1, order + 1))
    per = (n_knots + n_knots + (n_knots - 1) + n_w + 4 * n_terms
           + EXP[0] + 1 + DIV[0] + n_logistic * (3 + EXP[0] + DIV[0])
           + 2 * C * (1 + n_coeff + n_logistic))
    sfu = EXP[1] + DIV[1] + n_logistic * (EXP[1] + DIV[1])
    nbytes = io + 4 * (F * n_knots + 2 * F * n_logistic
                       + C * F * (1 + n_coeff + n_logistic) + B * C)
    return (B * (roll + F * per) + HW + 1 + F * n_w * (1 + DIV[0]),
            B * F * sfu + F * n_w * DIV[1], nbytes)


def kuramoto_case(device, B, seed):
    """A batch of ``B`` synthetic digits as initial phases, with a
    cotangent of the features and labels."""
    from fetode_tpu_torch.data.mnist import synthetic_digits
    from fetode_tpu_torch.ops import kuramoto as KO

    x, y = synthetic_digits(seed=seed, n=B)
    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(x).to(device)
    return dict(x=xt, y=torch.from_numpy(y).long().to(device),
                theta0=KO.theta0_of(xt, 28, 28),
                ct=torch.from_numpy(rng.standard_normal(
                    (B, 2 * 28 * 28)).astype(np.float32)).to(device))


def check_kuramoto_rollout(params, lat, case):
    """Phase 19 at one batch: (features max |diff|, the worst relative
    error of (theta0bar, omegabar, Kbar) against the two plain versions,
    their max |diff| against the written-out replay)."""
    from fetode_tpu_torch.ops import kuramoto as KO

    om, K, th0, ct = params.omega, params.K, case["theta0"], case["ct"]
    B = th0.shape[0]
    with torch.no_grad():
        feat = KO.kuramoto_fwd(om, K, th0, lat)
        torch.cuda.synchronize()
        want = KO.kuramoto_rollout_reference(om, K, th0, lat)
    if feat.shape != (B, 2 * lat.H * lat.W) or not torch.isfinite(feat).all():
        fail(f"kuramoto_fwd B={B}: shape {tuple(feat.shape)} or non-finite")
    fwd_err = max_abs(feat, want)
    if fwd_err > 1e-4:
        fail(f"kuramoto_fwd B={B}: max |diff| {fwd_err:.3e} from plain")
    got = KO.kuramoto_bwd(om, K, th0, ct, lat)
    again = KO.kuramoto_bwd(om, K, th0, ct, lat)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])):
        fail(f"kuramoto_bwd B={B}: omegabar or Kbar differ between two calls")
    replay = KO.kuramoto_rollout_bwd_reference(om, K, th0, ct, lat)
    leaves = [t.detach().clone().requires_grad_() for t in (th0, om, K)]
    torch.sum(KO.kuramoto_rollout_reference(leaves[1], leaves[2], leaves[0],
                                            lat) * ct).backward()
    auto = [t.grad for t in leaves]
    errs = [rel_err(g, w) for ref in (replay, auto) for g, w in zip(got, ref)]
    if max(errs) >= GRAD_TOL or not all(torch.isfinite(g).all() for g in got):
        fail(f"kuramoto_bwd B={B}: relative errors (theta0bar, omegabar, "
             f"Kbar) vs replay, autograd {[float('%.3e' % e) for e in errs]}")
    g_abs = max(max_abs(g, w) for g, w in zip(got, replay))
    print(f"kuramoto B={B}: features max |diff| {fwd_err:.3e}; backward rel "
          f"vs replay / autograd {[float('%.3e' % e) for e in errs]}; "
          "omegabar, Kbar bit-identical over two calls")
    return dict(fwd_err=fwd_err, g_rel=max(errs), g_abs=g_abs)


def mnist_step_fn(params, spec, x, y, rollout):
    """One MNIST training step (forward, cross-entropy, backward, AdamW) with
    the rollout ``rollout``, as a closure; learning rate 0."""
    import torch.nn.functional as F

    from fetode_tpu_torch.models.kuramoto import kuramoto_kan_apply
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    p = copy.deepcopy(params)
    state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                         kind="adamw", weight_decay=1e-4))
    s = spec._replace(rollout=rollout)
    step = make_train_step(lambda q, xb, yb: F.cross_entropy(
        kuramoto_kan_apply(q, s, xb), yb))
    return lambda: step(state, x, y)


def run_mnist_cli(cli, argv, epochs):
    """``cli.main(argv)`` with its output captured and echoed: returns the
    result and the epoch losses it printed."""
    import contextlib
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(argv)
    text = buf.getvalue()
    print(text, end="")
    losses = [float(v) for v in re.findall(r"^epoch \d+: loss (\S+) ", text,
                                           re.M)]
    if len(losses) != epochs or not np.isfinite(losses).all():
        fail(f"cli {' '.join(argv)}: epoch losses {losses}")
    return res, losses


def kuramoto_phases(device, smi):
    """Phases 19-23, the Kuramoto-MNIST slice: returns the kernel checks,
    the timings and the kernels' launches on the training and serving
    paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.models import kuramoto as TK
    from fetode_tpu_torch.ops import kuramoto as KO
    from fetode_tpu_torch.serve import load_servable

    spec = TK.KuramotoSpec(rollout="pallas")
    lat = spec.lattice
    params = TK.kuramoto_init(torch.Generator().manual_seed(0), spec,
                              device=device)
    with torch.no_grad():
        params.omega.copy_(torch.from_numpy(0.3 * np.random.default_rng(
            5).standard_normal((28, 28)).astype(np.float32)))
        params.K.fill_(0.7)
    cases = {b: kuramoto_case(device, b, 20 + i)
             for i, b in enumerate(sorted(set(KURA_LOGITS + KURA_TIMES)))}

    # ---- 19. B.10 against plain
    checks = {b: check_kuramoto_rollout(params, lat, cases[b])
              for b in KURA_CHECKS}

    # ---- 20. B.11 against plain; the fused gradient against the pallas one
    head = TK.head_operands(params.head)
    packed = KO.pack_head(*head)
    logit_errs = {}
    for b in KURA_LOGITS:
        args = (params.omega, params.K, cases[b]["theta0"], *head, lat)
        with torch.no_grad():
            got = KO.kuramoto_logits(*args)
            prepacked = KO.kuramoto_logits(*args, packed=packed)
            torch.cuda.synchronize()
            want = KO.kuramoto_logits_reference(*args)
        if got.shape != (b, 10) or not torch.isfinite(got).all():
            fail(f"kuramoto_logits B={b}: shape {tuple(got.shape)} or "
                 "non-finite")
        if not torch.equal(prepacked, got):
            fail(f"kuramoto_logits B={b}: the head packed once gives other "
                 "logits than one packed in the call")
        logit_errs[b] = max_abs(got, want)
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            fail(f"kuramoto_logits B={b}: max |diff| {logit_errs[b]:.3e} "
                 "from plain")
    print(f"kuramoto_logits vs plain, B {list(KURA_LOGITS)}: max |diff| "
          f"{[float('%.3e' % e) for e in logit_errs.values()]}")
    grads = []
    for rollout in ("pallas_fused", "pallas"):
        params.zero_grad()
        torch.nn.functional.cross_entropy(TK.kuramoto_kan_apply(
            params, spec._replace(rollout=rollout), cases[128]["x"]),
            cases[128]["y"]).backward()
        grads.append(flat([p.grad for p in params.parameters()]).clone())
    fused_rel = rel_err(grads[0], grads[1])
    if not fused_rel < GRAD_TOL:
        fail(f"pallas_fused gradient vs pallas: relative {fused_rel:.3e}")
    print(f"pallas_fused gradient vs pallas, B=128: relative {fused_rel:.3e}")

    # ---- 21. the training slice, through the CLI
    kernels = (KO.kuramoto_fwd, KO.kuramoto_bwd, KO.kuramoto_logits)
    launches = [0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        for rollout, epochs in (("pallas", 3), ("pallas_fused", 3),
                                ("auto", 1)):
            for f in kernels:
                f.launches = 0
            t0 = time.perf_counter()
            res, losses = count_spline(
                f"cli mnist --rollout {rollout}", lambda: run_mnist_cli(cli, [
                    "mnist", "--device", "cuda", "--rollout", rollout,
                    "--epochs", str(epochs), "--out-dir", tmp], epochs))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = [f.launches for f in kernels]
            need = counts if rollout == "pallas_fused" else counts[:2]
            if min(need) < 1 or (rollout != "pallas_fused" and counts[2]):
                fail(f"cli mnist --rollout {rollout}: launches {counts}")
            launches = [a + b for a, b in zip(launches, counts)]
            print(f"cli mnist --rollout {rollout} ({epochs} epochs): losses "
                  f"{losses}, test acc {res['test_acc']}; {wall:.2f} s; "
                  f"launches (kuramoto fwd, bwd, logits) {counts} ({smi})")

    # ---- 22. the serving slice, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["serve", "--source", "mnist", "--device", "cuda",
                "--buckets", "8,64,256", "--out-dir", tmp]
        for f in kernels:
            f.launches = 0
        sresult = cli.main(argv)
        cfg = make_config("serve", cli._parse(argv)[1])
        sparams, sfn, _ = cli.mnist_serving(cfg, device)
        sv = load_servable(sresult["bundle"], sfn, sparams)
        reqs = {b: cases[1024]["x"][:b] for b in (1, 30, 300)}
        # The serving function packs the head once, not per request.
        packs, pack_head = [], KO.pack_head
        KO.pack_head = lambda *a: packs.append(1) or pack_head(*a)
        try:
            served = {b: sv.predict(x) for b, x in reqs.items()}
        finally:
            KO.pack_head = pack_head
        torch.cuda.synchronize()
        counts = [f.launches for f in kernels]
        if counts[2] < 1:
            fail(f"serve --source mnist: launches {counts}")
        if len(packs) != 1:
            fail(f"serve --source mnist: the head was packed {len(packs)} "
                 f"times over {counts[2]} served calls, not once")
        launches = [a + b for a, b in zip(launches, counts)]
        with torch.no_grad():
            for b, x in reqs.items():
                want = sfn(sv.params, x)
                if served[b].shape != (b, 10) or \
                        not torch.isfinite(served[b]).all() or \
                        not torch.equal(served[b], want):
                    fail(f"serve mnist request B={b}: served output differs "
                         "from a direct call on the unpadded batch")
        wall, busy, top = profile_ms(lambda: sv.predict(cases[8]["x"]).cpu())
    print(f"serve mnist: B=1/30/300 through the bundle = direct calls on the "
          f"unpadded batches, the head packed once; launches {counts}; "
          f"profile bucket 8: wall "
          f"{wall:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    for row in sresult["bench"]:
        print(f"  serve mnist bucket {row['batch']}: p50 {row['p50_ms']:.4f} "
              f"ms, p99 {row['p99_ms']:.4f} ms, window p50s "
              f"{['%.4f' % w for w in row['window_p50_ms']]} ({smi})")

    # ---- 23. timing: kernels and plain, a training step
    times = {}
    om, K = params.omega.detach(), params.K.detach()
    for b in sorted(set(KURA_TIMES + KURA_LOGITS)):
        c = cases[b]
        th0, ct = c["theta0"], c["ct"]
        args = (om, K, th0, *[None if t is None else t.detach()
                              for t in head], lat)
        t = {}
        with torch.no_grad():
            logits = lambda: KO.kuramoto_logits(  # noqa: E731
                *args, packed=packed)
            t["logits_events"] = cuda_ms(logits, 20)
            t["logits"] = queued_ms(logits)
            t["plain_logits"] = cuda_ms(
                lambda: KO.kuramoto_logits_reference(*args), 3)
            if b in KURA_TIMES:
                fwd = lambda: KO.kuramoto_fwd(om, K, th0, lat)  # noqa: E731
                bwd = lambda: KO.kuramoto_bwd(om, K, th0, ct, lat)  # noqa
                t["fwd_events"], t["bwd_events"] = cuda_ms(fwd, 20), \
                    cuda_ms(bwd, 20)
                t["fwd"], t["bwd"] = queued_ms(fwd), queued_ms(bwd)
                t["plain_fwd"] = cuda_ms(
                    lambda: KO.kuramoto_rollout_reference(om, K, th0, lat), 3)
                t["plain_bwd"] = cuda_ms(
                    lambda: KO.kuramoto_rollout_bwd_reference(om, K, th0, ct,
                                                              lat), 3)
        for kind in ("fwd", "bwd", "logits"):
            if kind in t:
                t[f"bound_{kind}"] = bound(*kuramoto_counts(b, 28, 28, 10,
                                                            kind))
        times[b] = t
        print(f"time kuramoto B={b}: " + ", ".join(
            f"{k} {t[k]:.4f} ms on the device ({t[k + '_events']:.4f} ms a "
            f"call back to back) vs plain {t['plain_' + k]:.4f} ms, bound "
            f"{t['bound_' + k][0]:.5f} ms ({t['bound_' + k][2]})"
            for k in ("fwd", "bwd", "logits") if k in t) + f" ({smi})")
    c = cases[128]
    for rollout in ("pallas", "pallas_fused", "scan"):
        step = mnist_step_fn(params, spec, c["x"], c["y"], rollout)
        ms = cuda_ms(step, 10 if rollout != "scan" else 3)
        wall, busy, top = profile_ms(step)
        times[("step", rollout)] = ms
        print(f"time MNIST training step B=128 --rollout {rollout}: {ms:.4f} "
              f"ms; profiled: wall {wall:.4f} ms, device busy {busy:.4f} ms "
              f"({100 * busy / wall:.1f}%), top "
              f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    return checks, logit_errs, times, launches

# ------------------------------------------------------ cond diffusion


def node_enc_counts(B, C, P, H, L, recs, kind):
    """(FP32, SFU, bytes) of a node-encoder kernel call: ``fwd`` (2 + 6
    per attempt field evaluations of four products (2 B (C H + P H + H H
    + H C)), the layer norm, the x(t) lerp and 2 B H SiLUs; the step
    arithmetic, the dense output at t = 1 and, with records, the records)
    or ``bwd`` (per accepted attempt 6 field VJPs, 7 in the step that
    reaches t = 1: the hidden layers again and eight products, the SiLU
    derivatives, the LN backward and the two-row scatter)."""
    N = B * C
    n_att = int(recs.misc[0])
    tda = recs.tda[:n_att].cpu().numpy()
    n_acc = int(tda[:, 1].sum())
    n_par = 2 * C + H * (C + P) + H + H * H + H + C * H + C
    rec_floats = n_att * (4 + 8 * N) + 4
    table = L * B * P
    hidden = (2 * B * (C * H + P * H + H * H) + 8 * N + 3 * B * P
              + 2 * B * H * (SIG[0] + 2), 2 * B * H * SIG[1])
    ev = (hidden[0] + 2 * B * H * C + N, hidden[1])
    if kind == "fwd":
        n = 2 + 6 * n_att
        return (n * ev[0] + N * (80 * n_att + 40), n * ev[1],
                4 * (N + table + 2 + n_par + N + rec_floats))
    n_vjp = 6 * n_acc + 1
    vjp = (hidden[0] + 4 * B * (2 * C * H + H * H + H * P)
           + 2 * B * H * 4 + 10 * N + 4 * B * P, hidden[1])
    return (n_vjp * vjp[0] + N * 100 * n_acc, n_vjp * vjp[1],
            4 * (N + 2 + rec_floats + table + 2 * n_par + table + N))


def cond_windows():
    """The past windows (96 steps of 7 columns) of every split of the
    synthetic series that ``cli cond_diffusion`` falls back to, as one
    array: 931 train, 31 validation and 181 test windows."""
    from fetode_tpu_torch.data.timeseries import (
        make_windows,
        split_time_series,
        standardize_fit,
        synthetic_series,
    )

    X, _ = synthetic_series(n=1500, n_features=6)
    splits = split_time_series(len(X))
    Xs = standardize_fit(X[splits[0]]).apply(X)
    return np.concatenate([make_windows(Xs[sl], Xs[sl][:, -1], 96, 24)[0]
                           for sl in splits])


def node_enc_case(enc, cfg, x_seq):
    """B.8's kernels for one batch's projected past ``x_seq`` as closures,
    with their plain versions, weights and operation counts (the
    ``check_node_kernels`` / ``time_node_kernels`` contract): the x_seq
    cotangent comes last among the gradients, and the full gradients are
    taken of the field / LN tensors and of x_seq."""
    from fetode_tpu_torch.ops import node_common as NC
    from fetode_tpu_torch.ops import node_enc as NE

    w = NE.field_weights(enc)
    x = x_seq.detach().requires_grad_(True)
    ts = NE._ts(x_seq.device)
    _, L, P = x_seq.shape

    def bwd(z0, recs, ct):
        grads, z0bar, xbar = NE.node_enc_bwd(w, z0, x_seq, recs, ct)
        return list(grads) + [xbar], z0bar

    def plain_bwd(z0, recs, ct):
        # autograd of the plain replay, x_seq a leaf among the weights
        leaves = [t.detach().requires_grad_(True) for t in w + [x_seq]]
        ybar = torch.stack([torch.zeros_like(ct), ct])
        return NC.replay_traj_vjp_reference(
            NE.node_enc_field(leaves[:-1], leaves[-1]), leaves, z0, ts,
            recs, ybar)

    def plain_fwd(z0):
        traj, recs = NC.record_solve_traj_reference(
            NE.node_enc_field(w, x_seq), z0, ts, max_steps=cfg.max_steps)
        return traj[1], recs

    return dict(
        name="node_enc",
        fwd=lambda z0, record=True: NE.node_enc_fwd(w, z0, x_seq,
                                                    record=record),
        bwd=bwd,
        solve=lambda z0: NE.node_enc_solve(enc, cfg, z0, x),
        plain_fwd=plain_fwd,
        plain_bwd=plain_bwd,
        plain_solve=lambda z0: NC.solve_traj_reference(
            NE.node_enc_field(NE.field_weights(enc), x), z0, ts,
            max_steps=cfg.max_steps)[1],
        weights=[enc.ln_scale, enc.ln_bias] + [
            t for layer in enc.field for t in (layer.w, layer.b)] + [x],
        counts=lambda B, recs, kind: node_enc_counts(
            B, cfg.cond_dim, P, cfg.ode_hidden, L, recs, kind))


def log_batches(module, names, batches):
    """Wrap ``module``'s launchers so that each call records the batch it
    launches at into ``batches``; ``names`` maps a launcher's name to the
    position of its argument whose first axis is the batch.  Returns the
    undo."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def launch(*args, **kw):
            batches.add((n, args[names[n]].shape[0]))
            return fn(*args, **kw)
        return launch
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def cond_diffusion_phases(device, smi):
    """Phases 24-27, the conditional-diffusion slice: returns the kernel
    checks, the timings and the kernels' launches on the training and
    serving paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.models import cond_diffusion as CD
    from fetode_tpu_torch.nn.diffusion import make_schedule
    from fetode_tpu_torch.ops import node_enc as NE
    from fetode_tpu_torch.serve import load_servable
    from fetode_tpu_torch.train import cond_diffusion_driver as drv
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    wins = cond_windows()
    rng_c = np.random.default_rng(6)

    def xs(b, off=0):
        return torch.from_numpy(wins[(off + np.arange(b)) % len(wins)]).to(
            device)

    # ---- 24. B.8 against plain, at the encoder's width
    cfg = CD.NodeEncoderCfg(d_in=wins.shape[2])
    enc = CD.node_encoder_init(torch.Generator().manual_seed(0), cfg,
                               device=device)
    inputs, cases, checks = {}, {}, {}
    for b in NODE_ENC_CHECKS:
        with torch.no_grad():
            x_seq = xs(b, 13 * b) @ enc.x_proj_w.T + enc.x_proj_b
            z0 = x_seq[:, 0] @ enc.z0_w.T + enc.z0_b
        ct = torch.from_numpy(rng_c.standard_normal(
            (b, cfg.cond_dim)).astype(np.float32)).to(device)
        inputs[b], cases[b] = (z0, ct), node_enc_case(enc, cfg, x_seq)
        checks[b] = check_node_kernels(cases[b], z0, ct)
        # the x_seq cotangent on its own, and the same bits in two calls
        with torch.no_grad():
            _, recs = cases[b]["fwd"](z0)
        got = [cases[b]["bwd"](z0, recs, ct) for _ in range(2)]
        want, _ = cases[b]["plain_bwd"](z0, recs, ct)
        torch.cuda.synchronize()
        x_rel = rel_err(got[0][0][-1], want[-1])
        if not x_rel < GRAD_TOL:
            fail(f"node_enc B={b}: x_seq cotangent rel {x_rel:.3e}")
        if not all(torch.equal(p, q) for p, q in zip(
                got[0][0] + [got[0][1]], got[1][0] + [got[1][1]])):
            fail(f"node_enc B={b}: the backward kernel's gradients differ "
                 "between two calls")
        print(f"node_enc B={b}: x_seq cotangent rel {x_rel:.3e}; the same "
              "bits in two calls")

    # ---- 25. the training slice, through the CLI
    kernels = (NE.node_enc_fwd, NE.node_enc_bwd)
    launches = [0, 0]
    batches = set()
    undo = log_batches(NE, {"_launch_fwd": 1, "_launch_bwd": 2}, batches)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for denoiser in ("kan_fet_all_node", "kan_node"):
                for f in kernels:
                    f.launches = 0
                t0 = time.perf_counter()
                res = count_spline(
                    f"cli cond_diffusion --denoiser {denoiser}",
                    lambda: cli.main(["cond_diffusion", "--denoiser",
                                      denoiser, "--device", "cuda",
                                      "--epochs", "1", "--out-dir", tmp]))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = [f.launches for f in kernels]
                if min(counts) < 1:
                    fail(f"cli cond_diffusion --denoiser {denoiser}: kernel "
                         f"launches {counts}")
                curves = res["train_curve"] + res["val_curve"] + [
                    res["test_mse"], res["test_mae"]]
                if not np.isfinite(curves).all():
                    fail(f"cli cond_diffusion --denoiser {denoiser}: "
                         f"non-finite losses {curves}")
                launches = [a + b for a, b in zip(launches, counts)]
                print(f"cli cond_diffusion --denoiser {denoiser} (1 epoch, "
                      f"auto): train {res['train_curve']}, val "
                      f"{res['val_curve']}, test MSE {res['test_mse']:.5f} "
                      f"MAE {res['test_mae']:.5f}; training "
                      f"{res['wall_seconds']:.2f} s, whole run {wall:.2f} s;"
                      f" launches (node_enc fwd, bwd) {counts} ({smi})")

        # ---- 26. the serving slice, through the CLI
        reqs = {b: xs(b, 3 * b) for b in (1, 30, 300)}
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["serve", "--source", "cond_diffusion", "--device", "cuda",
                    "--buckets", "8,64,256", "--iters", str(SERVE_ITERS),
                    "--out-dir", tmp]
            for f in kernels:
                f.launches = 0
            t0 = time.perf_counter()
            sresult = count_spline("serve cond_diffusion (phase 26)",
                                   lambda: cli.main(argv))
            serve_wall = time.perf_counter() - t0
            cfg_s = make_config("serve", cli._parse(argv)[1])
            sparams, sfn, _ = cli.SERVING["cond_diffusion"](cfg_s, device)
            sv = load_servable(sresult["bundle"], sfn, sparams)
            served = {b: sv.predict(x) for b, x in reqs.items()}
            torch.cuda.synchronize()
            counts = [f.launches for f in kernels]
            if counts[0] < 1 or counts[1]:
                fail(f"serve --source cond_diffusion: kernel launches "
                     f"{counts}")
            launches = [a + b for a, b in zip(launches, counts)]
            check_served(sv, sfn, reqs, served, "serve cond_diffusion")
            serve_lines("serve cond_diffusion", sresult["bench"],
                        lambda b: sv.predict(xs(b)).cpu(), smi, n=2)
    finally:
        undo()
    seen = sorted(b for _, b in batches)
    if not set(seen) <= set(NODE_ENC_CHECKS):
        fail(f"the path launched node_enc at batches {seen}, phase 24 "
             f"checked {list(NODE_ENC_CHECKS)}")
    print(f"node_enc launches on the path at batches "
          f"{sorted(batches)}; all checked in phase 24")
    print(f"serve cond_diffusion: B=1/30/300 through the bundle = direct "
          f"calls on the padded batches; launches {counts}; the CLI call "
          f"{serve_wall:.2f} s ({smi})")

    # ---- 27. timing: kernels and plain, a training step
    times = {b: time_node_kernels(cases[b], *inputs[b], smi)
             for b in (64, 256)}

    spec = CD.make_denoiser_spec("kan_fet_all_node", d_in=wins.shape[2],
                                 pred_len=24)
    params = CD.cond_denoiser_init(torch.Generator().manual_seed(0), spec,
                                   device=device)
    sched = make_schedule(250, device=device)
    past = xs(64)
    fut = torch.from_numpy(rng_c.standard_normal((64, 24, 7)).astype(
        np.float32)).to(device)

    def step_fn(mode):
        p = copy.deepcopy(params)
        state = init_state(p, make_optimizer(
            0.0, params=p.parameters(), kind="adamw", weight_decay=1e-4,
            grad_clip=1.0))
        s = spec._replace(solver_mode=mode)

        def loss(q, xb, yb):
            g = torch.Generator(device=device).manual_seed(0)
            return drv.cond_diffusion_loss(q, s, sched, xb, yb, g)
        step = make_train_step(loss)
        return lambda: step(state, past, fut)

    step_k = step_fn("auto")
    kernel = cuda_ms(step_k, 5)
    eager = cuda_ms(step_fn("scan"), 1)
    wall, busy, top = profile_ms(step_k)
    times["step"] = dict(kernel=kernel, eager=eager, wall=wall, busy=busy)
    print(f"time cond_diffusion training step kan_fet_all_node B=64: "
          f"kernels {kernel:.4f} ms, eager scan solve {eager:.3f} ms; "
          f"profiled: wall {wall:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    return checks, times, launches


# ------------------------------------------------------- ECG 'mlp' field


def mlp_case(params, spec, name="mlp_node"):
    """B.6's kernels for a 'mlp' ``KanFetNODE`` as closures (the
    ``check_node_kernels`` / ``time_node_kernels`` contract): the
    operands are formed once from ``params``; the full gradients are taken
    of the field's parameters, each solve forming its operands anew."""
    from fetode_tpu_torch.ops import mlp_node as MN
    from fetode_tpu_torch.ops import node_common as NC

    w = MN.mlp_weights(params)
    hb = spec.h_bound
    opts = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    field = MN.mlp_field(w, hb)
    layers = params.kan.layers
    return dict(
        name=name,
        fwd=lambda h0, record=True: MN.mlp_node_fwd(w, h0, h_bound=hb,
                                                    record=record, **opts),
        bwd=lambda h0, recs, hbar: MN.mlp_node_bwd(w, h0, recs, hbar,
                                                   h_bound=hb),
        solve=lambda h0: MN.mlp_node_solve(params, h0, spec),
        plain_fwd=lambda h0: NC.record_solve_reference(field, h0, **opts),
        plain_bwd=lambda h0, recs, hbar: NC.replay_vjp_reference(
            field, MN.grad_weights(w), h0, recs, hbar),
        plain_solve=lambda h0: NC.solve_reference(
            MN.mlp_field(MN.mlp_weights(params), hb), h0, **opts),
        weights=[params.ln_scale, params.ln_bias, params.field_mixer.a,
                 params.field_mixer.b] + [
            t for layer in layers for t in (layer.base_weight,
                                            layer.spline_weight,
                                            layer.spline_scaler)] + [
            params.out_w, params.out_b, params.log_alpha, params.scale],
        counts=lambda B, recs, kind: mlp_counts(
            B, spec.latent_dim, spec.num_basis, spec.ode_hidden, recs, kind))


def mlp_phases(device, smi):
    """Phases 28-31, the ECG 'mlp' field slice: returns the kernel checks,
    the timings and the kernels' launches on the training and serving
    paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.ops import mlp_node as MN
    from fetode_tpu_torch.serve import load_servable

    # ---- 28. B.6 against plain, at ECGPreset's width
    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])        # 96 series of 96
    rng_m = np.random.default_rng(8)
    spec = M.KanFetNODESpec(num_basis=12, field="mlp")
    params = M.kanfet_node_init(torch.Generator().manual_seed(0), spec,
                                device=device)
    # The init's field is tiny (out_w std 1e-3, log_alpha -3): one step
    # reaches t = 1.  A second set, out_w with std 4, log_alpha 0.5 and
    # both KAN layers' weights tripled, takes several attempts.
    scaled = copy.deepcopy(params)
    with torch.no_grad():
        scaled.out_w.copy_(4.0 * torch.from_numpy(rng_m.standard_normal(
            tuple(scaled.out_w.shape)).astype(np.float32)).to(device))
        scaled.log_alpha.fill_(0.5)
        for layer in scaled.kan.layers:
            layer.base_weight.mul_(3.0)
            layer.spline_weight.mul_(3.0)
    cases = {"init": mlp_case(params, spec),
             "scaled": mlp_case(scaled, spec, "mlp_node scaled")}
    xs = {b: torch.from_numpy((series[np.arange(b) % len(series)] + 0.05
                               * rng_m.standard_normal((b, series.shape[1]))
                               ).astype(np.float32)).to(device)
          for b in MLP_CHECKS}
    with torch.no_grad():
        h0s = {b: x @ params.encoder_w.T + params.encoder_b
               for b, x in xs.items()}
    hbars = {b: torch.from_numpy(rng_m.standard_normal(
        (b, spec.latent_dim)).astype(np.float32)).to(device)
        for b in MLP_CHECKS}
    checks = {}
    for regime, case in cases.items():
        for b in MLP_CHECKS:
            checks[(regime, b)] = check_node_kernels(case, h0s[b], hbars[b])
            # every gradient on its own, and the same bits in two calls
            with torch.no_grad():
                _, recs = case["fwd"](h0s[b])
            got = [case["bwd"](h0s[b], recs, hbars[b]) for _ in range(2)]
            want, want_h = case["plain_bwd"](h0s[b], recs, hbars[b])
            torch.cuda.synchronize()
            rels = [rel_err(g, r) for g, r in zip(got[0][0], want)
                    if r.norm() > 0] + [rel_err(got[0][1], want_h)]
            if not max(rels) < GRAD_TOL:
                fail(f"mlp_node {regime} B={b}: gradient rel errors {rels}")
            if not all(torch.equal(p, q) for p, q in zip(
                    got[0][0] + [got[0][1]], got[1][0] + [got[1][1]])):
                fail(f"mlp_node {regime} B={b}: the backward kernel's "
                     "gradients differ between two calls")
            print(f"mlp_node {regime} B={b}: worst of the 11 gradients and "
                  f"h0bar rel {max(rels):.3e}; the same bits in two calls")

    # ---- 29. the training slice, through the CLI
    kernels = (MN.mlp_node_fwd, MN.mlp_node_bwd)
    launches = [0, 0]
    batches = set()
    undo = log_batches(MN, {"_launch_fwd": 1, "_launch_bwd": 2}, batches)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for f in kernels:
                f.launches = 0
            res = cli.main(["ecg", "--model", "kanfet_node", "--field", "mlp",
                            "--solver_mode", "pallas", "--device", "cuda",
                            "--epochs", "3", "--out-dir", tmp])
            torch.cuda.synchronize()
            counts = [f.launches for f in kernels]
            if min(counts) < 1:
                fail(f"cli ecg --field mlp: kernel launches {counts}")
            if not np.isfinite(res["loss_curve"]).all():
                fail(f"cli ecg --field mlp: non-finite losses "
                     f"{res['loss_curve']}")
            launches = [a + b for a, b in zip(launches, counts)]
            print(f"cli ecg --model kanfet_node --field mlp (3 epochs, "
                  f"pallas): losses {[round(v, 4) for v in res['loss_curve']]}"
                  f", test acc {res['test_acc_curve']}, best "
                  f"{res['best_test_acc']}; {res['wall_seconds']:.2f} s; "
                  f"launches (mlp fwd, bwd) {counts} ({smi})")

        # ---- 30. the serving slice, through the CLI
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["serve", "--source", "ecg", "--field", "mlp",
                    "--solver_mode", "pallas", "--device", "cuda",
                    "--buckets", "8,64,256", "--out-dir", tmp]
            for f in kernels:
                f.launches = 0
            sresult = cli.main(argv)
            cfg = make_config("serve", cli._parse(argv)[1])
            sparams, sfn, _ = cli.ecg_serving(cfg, device)
            sv = load_servable(sresult["bundle"], sfn, sparams)
            reqs = {b: torch.from_numpy(np.resize(series, (b, cfg.t_len))).to(
                device) for b in (1, 30, 300)}
            served = {b: sv.predict(x) for b, x in reqs.items()}
            torch.cuda.synchronize()
            counts = [f.launches for f in kernels]
            if counts[0] < 1 or counts[1]:
                fail(f"serve --source ecg --field mlp: kernel launches "
                     f"{counts}")
            launches = [a + b for a, b in zip(launches, counts)]
            check_served(sv, sfn, reqs, served, "ECG mlp")
            wall, busy, top = profile_ms(lambda: sv.predict(xs[8]).cpu())
    finally:
        undo()
    seen = sorted(b for _, b in batches)
    if not set(seen) <= set(MLP_CHECKS):
        fail(f"the path launched mlp_node at batches {seen}, phase 28 "
             f"checked {list(MLP_CHECKS)}")
    print(f"mlp_node launches on the path at batches {sorted(batches)}; all "
          f"checked in phase 28")
    print(f"serve --source ecg --field mlp: B=1/30/300 through the bundle = "
          f"direct kernel calls on the padded batches; launches {counts}; "
          f"profile bucket 8: wall {wall:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    for row in sresult["bench"]:
        print(f"  serve ecg mlp bucket {row['batch']}: p50 {row['p50_ms']:.4f}"
              f" ms, p99 {row['p99_ms']:.4f} ms, window p50s "
              f"{['%.4f' % w for w in row['window_p50_ms']]} ({smi})")

    # ---- 31. timing: kernels and plain, a training step
    times = {b: time_node_kernels(cases["init"], h0s[b], hbars[b], smi)
             for b in (8, 64)}
    times[256] = time_node_kernels(cases["init"], h0s[256], hbars[256], smi,
                                   plain=False)
    times["scaled"] = time_node_kernels(cases["scaled"], h0s[8], hbars[8],
                                        smi)
    y8 = torch.from_numpy(data[1][:8]).long().to(device)
    step_k = ecg_step_fn(M.kanfet_node_apply, params, spec, xs[8], y8,
                         "pallas")
    kernel = cuda_ms(step_k, 10)
    eager = cuda_ms(ecg_step_fn(M.kanfet_node_apply, params, spec, xs[8], y8,
                                "scan"), 1)
    wall, busy, top = profile_ms(step_k)
    times["step"] = dict(kernel=kernel, eager=eager, wall=wall, busy=busy)
    print(f"time ECG training step kanfet_node --field mlp B=8: kernels "
          f"{kernel:.4f} ms, eager scan solve {eager:.3f} ms; profiled: wall "
          f"{wall:.4f} ms, device busy {busy:.4f} ms "
          f"({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    return checks, times, launches


# ------------------------------------------------- wide predprey stacks


def kanfet_wide_eval_counts(cfg):
    """(FP32, SFU) of one B.3 field evaluation and of one field VJP, for
    one trajectory.  As ``kanfet_eval_counts`` counts an evaluation, but
    at the fresh frozen state a ferro term is one sigmoid and one tanh
    (target = 1 - 2 (1 - mu) cn, the TPU kernel's form) and mu one
    sigmoid an input.  The VJP's least work takes cn and tanh once per
    edge and k (the layers' inputs with them) and forms every derivative
    from those values (sech^2 = 1 - th^2, dcn = -g cn (1 - cn)): the
    evaluation's SFU, and on top of its FP32, per term 24 (the input
    cotangent and the five ferro gradients), per edge 4 + 4 C (base and
    spline, forward and gradient), per input 3 + 4 C (silu' and B')."""
    ev = [0, 0]
    vjp_fp32 = 0
    for c in cfg.layers:
        i, o, K = c.in_features, c.out_features, c.ferro_num_basis
        C = c.grid_size + c.spline_order
        nk = c.grid_size + 2 * c.spline_order + 1
        fp32 = (i * (2 + SIG[0]) + i * (1 + SIG[0])
                + i * nk * (1 + 10 * c.spline_order)
                + i * o * (2 + 2 * C) + i * o * K * (10 + SIG[0] + TANH[0]))
        ev[0] += fp32
        ev[1] += 2 * i * SIG[1] + i * o * K * (SIG[1] + TANH[1])
        vjp_fp32 += (fp32 + i * o * K * 24 + i * o * (4 + 4 * C)
                     + i * (3 + 4 * C))
    return tuple(ev), (vjp_fp32, ev[1])


def kanfet_wide_counts(n_par, cfg, B, ts, recs, kind):
    """(FP32, SFU, bytes) of a B.3 call ([D, ..., D] KANFET stack, batch
    B): ``fwd`` (2 + 6 per attempt field evaluations of B rows, the step
    arithmetic, the dense output and the records) or ``bwd`` (per
    accepted attempt 6 field VJPs of B rows, 7 when an output time falls
    in its window), from ``kanfet_wide_eval_counts``; ``n_par`` operand
    floats, the grids among them (they get no gradient)."""
    ev, vjp = kanfet_wide_eval_counts(cfg)
    D = cfg.layers[0].in_features
    N = B * D
    n_att = int(recs.misc[0])
    tda = recs.tda[:n_att].cpu().numpy()
    tsn = ts.cpu().numpy()
    T = len(tsn)
    acc = [(t, dt) for dt, a, t, _ in tda if a > 0.5]
    rec_floats = n_att * (4 + 8 * N) + 4
    if kind == "fwd":
        n = (2 + 6 * n_att) * B
        return (n * ev[0] + N * (80 * n_att + 40 * T), n * ev[1],
                4 * (N + T + n_par + T * N + rec_floats))
    grids = sum(c.in_features * (c.grid_size + 2 * c.spline_order + 1)
                for c in cfg.layers)
    n = B * sum(6 + int(any(t < v <= t + dt for v in tsn)) for t, dt in acc)
    return (n * vjp[0] + N * 100 * len(acc), n * vjp[1],
            4 * (T * N + T + rec_floats + 2 * n_par - grids + N))


def wide_params(spec, device, regime):
    """A stack's parameters from a seed: the init, or ("scaled") every
    layer's ferro coef and base weight times 1.5 (a stiffer field)."""
    from fetode_tpu_torch.models.predprey import predprey_init

    params = predprey_init(torch.Generator().manual_seed(0), spec,
                           device=device)
    if regime == "scaled":
        with torch.no_grad():
            for layer in params.layers:
                layer.ferro.coef.mul_(1.5)
                layer.base_weight.mul_(1.5)
    return params


def same_records(r1, r2):
    """Two solves' records the same bits: the attempt table and the
    states and stages of the attempts made (the rows past them are never
    written)."""
    n = int(r1.misc[0])
    return (torch.equal(r1.tda, r2.tda) and torch.equal(r1.misc, r2.misc)
            and torch.equal(r1.yrec[:n], r2.yrec[:n])
            and torch.equal(r1.krec[:n], r2.krec[:n]))


def check_wide(params, cfg, x0, target, ts, opts, label, same_attempts):
    """Phase 32 at one stack, batch, parameter set and tolerance: both
    forward kernels against plain's replay of the kernel's records, the
    attempts against the plain recording solve's (equal when
    ``same_attempts``, the loose tolerance; otherwise within
    ``WIDE_ATTEMPTS`` of plain's and at least 3, the same time reached,
    and the outputs of the two
    solves on the times both reached); with the cotangent of the training
    loss's MSE against ``target`` (T, B, D), the backward on the kernel's
    records, twice, against autograd of the float64 plain replay of the
    same records (gradients and x0bar each within 1e-4; one that misses
    it within 4x the float32 plain replay's own error, capped at
    ``GRAD_CAP``, and the line says so), and, with ``same_attempts``, the
    kernel's gradient against the plain one, each on its own mesh."""
    from fetode_tpu_torch.ops import kanfet_wide as KW
    from fetode_tpu_torch.ops import node_common as NC

    w = KW.wide_weights(params)
    field = KW.wide_field(w, cfg)
    with torch.no_grad():
        y_k, r_k = KW.kanfet_wide_fwd(w, cfg, x0, ts, **opts)
        y_k2, r_k2 = KW.kanfet_wide_fwd(w, cfg, x0, ts, **opts)
        y_n, _ = KW.kanfet_wide_fwd(w, cfg, x0, ts, record=False, **opts)
        torch.cuda.synchronize()
        y_p, r_p = NC.record_solve_traj_reference(field, x0, ts, **opts)
    if not (torch.isfinite(y_k).all() and torch.isfinite(y_p).all()):
        fail(f"{label}: non-finite forward output")
    if not torch.equal(y_k, y_n):
        fail(f"{label}: the forward kernel's output depends on recording")
    if not (torch.equal(y_k, y_k2) and same_records(r_k, r_k2)):
        fail(f"{label}: the forward kernel's output or records differ "
             "between two calls")
    dims = tuple((c.in_features, c.out_features, c.ferro_num_basis)
                 for c in cfg.layers)
    ctas = KW.cluster_plan(x0.shape[0], dims)
    n_k, n_p = int(r_k.misc[0]), int(r_p.misc[0])
    t_k, t_p = float(r_k.misc[1]), float(r_p.misc[1])
    if same_attempts and n_k != n_p:
        fail(f"{label}: {n_k} attempts in the kernel, {n_p} in plain")
    n_tol = max(3, math.ceil(WIDE_ATTEMPTS * n_p))
    if abs(n_k - n_p) > n_tol or abs(t_k - t_p) > 1e-6 * abs(t_p):
        fail(f"{label}: the kernel took {n_k} attempts to t = {t_k}, plain "
             f"{n_p} to t = {t_p} (at most {n_tol} apart)")
    # The forward on the kernel's own mesh: plain's replay of its records.
    with torch.no_grad():
        y_r = NC.replay_traj_reference(field, x0, ts, r_k)
    mesh_err = max_abs(y_k, y_r)
    if not torch.allclose(y_k, y_r, rtol=TOL, atol=TOL):
        fail(f"{label}: forward kernel disagrees with plain's replay of its "
             f"mesh (max |diff| {mesh_err:.3e})")
    # Each on its own mesh, on the times both reached: the two meshes part
    # by float32 rounding, so the outputs part by about the solve's own
    # error; held where that is far below TOL (the preset's rtol 1e-7).
    t_both = float(min(r_k.misc[1], r_p.misc[1]))
    reached = ts <= t_both
    fwd_err = max_abs(y_k[reached], y_p[reached])
    if not same_attempts and not torch.allclose(
            y_k[reached], y_p[reached], rtol=TOL, atol=TOL):
        fail(f"{label}: forward kernel disagrees with plain (max |diff| "
             f"{fwd_err:.3e})")
    ct = 2.0 * (y_k - target) / y_k.numel()
    got = [KW.kanfet_wide_bwd(w, cfg, x0, ts, r_k, ct) for _ in range(2)]
    torch.cuda.synchronize()
    (g_k, xb_k), (g_k2, xb_k2) = got
    if not all(torch.isfinite(g).all() for g in g_k + [xb_k]):
        fail(f"{label}: non-finite kernel gradients")
    if not all(torch.equal(a, b) for a, b in zip(g_k + [xb_k],
                                                 g_k2 + [xb_k2])):
        fail(f"{label}: the backward kernel's gradients differ between two "
             "calls")
    w64 = [t.double() for t in w]
    g_p, xb_p = NC.replay_traj_vjp_reference(
        KW.wide_field(w64, cfg), KW.grad_weights(w64), x0.double(), ts,
        NC.SolveRecords(*(r.double() for r in r_k)), ct.double())
    g_rel = rel_err(flat(g_k).double(), flat(g_p))
    x_rel = rel_err(xb_k.double(), xb_p)
    g_tol = x_tol = GRAD_TOL
    widened = ""
    if not (g_rel < g_tol and x_rel < x_tol):
        # float32's own reach: the float32 plain replay against float64,
        # for the number that missed 1e-4 only.
        g_32, xb_32 = NC.replay_traj_vjp_reference(
            field, KW.grad_weights(w), x0, ts, r_k, ct)
        if not g_rel < g_tol:
            e32 = rel_err(flat(g_32).double(), flat(g_p))
            g_tol = min(GRAD_CAP, max(g_tol, 4 * e32))
            widened += f"; grads bound widened (float32 plain {e32:.2e})"
        if not x_rel < x_tol:
            e32 = rel_err(xb_32.double(), xb_p)
            x_tol = min(GRAD_CAP, max(x_tol, 4 * e32))
            widened += f"; x0bar bound widened (float32 plain {e32:.2e})"
    if not (g_rel < g_tol and x_rel < x_tol):
        fail(f"{label}: backward kernel vs float64 plain replay on the "
             f"kernel's mesh: grads rel {g_rel:.3e} (bound {g_tol:.1e}), "
             f"x0bar rel {x_rel:.3e} (bound {x_tol:.1e})")
    gk = flat(g_k)
    cos = None
    if same_attempts:      # at the preset the meshes part by rounding only
        g_o, _ = NC.replay_traj_vjp_reference(field, KW.grad_weights(w), x0,
                                              ts, r_p, ct)
        go = flat(g_o)
        cos = float(torch.dot(gk, go) / (gk.norm() * go.norm()))
        if not cos > COS_MIN:
            fail(f"{label}: own-mesh gradient cosine {cos:.6f}")
    print(f"{label}: a cluster of {ctas} CTAs; attempts kernel "
          f"{n_k} (accepted {int(r_k.tda[:n_k, 1].sum())}), plain {n_p}; "
          f"forward the same bits twice, max |diff| "
          f"{mesh_err:.3e} on the kernel's mesh, {fwd_err:.3e} on own meshes "
          f"to t = {t_both:.4f}; backward on the kernel's mesh "
          f"vs float64 plain: grads rel {g_rel:.3e} (bound {g_tol:.1e}), "
          f"x0bar rel {x_rel:.3e} (bound {x_tol:.1e}){widened}, the same "
          "bits twice"
          + (f"; own-mesh cosine {cos:.7f}" if same_attempts else ""))
    return dict(fwd_err=mesh_err, own_err=fwd_err, g_rel=g_rel, x_rel=x_rel,
                cos=cos,
                g_abs=max(max_abs(gk.double(), flat(g_p)),
                          max_abs(xb_k.double(), xb_p)),
                n_k=n_k, n_p=n_p, recs=r_k)


def b2_records_as_traj(records, D):
    """B.2's per-trajectory records of one trajectory as node_common's
    ``SolveRecords`` (the layout B.3 replays)."""
    from fetode_tpu_torch.ops import node_common as NC

    rec, n_att, t_end = records
    M = rec.shape[0]
    r = rec[:, :, 0]                                    # (M, 3 + 8D)
    tda = torch.stack([r[:, 1], r[:, 2], r[:, 0], torch.zeros_like(r[:, 0])],
                      dim=1)
    misc = torch.zeros(4, dtype=rec.dtype, device=rec.device)
    misc[0], misc[1] = n_att[0].to(rec.dtype), t_end[0]
    return NC.SolveRecords(tda.contiguous(),
                           r[:, 3:3 + D].reshape(M, 1, D).contiguous(),
                           r[:, 3 + D:].reshape(M, 7, 1, D).contiguous(),
                           misc)


def module_grads(params, g_ops):
    """B.3's operand gradients (7 a layer) on the module's parameters, in
    ``kanfet_adjoint.train_weights`` order: the spline scaler's chain."""
    out = []
    for i, layer in enumerate(params.layers):
        g = g_ops[7 * i:7 * i + 7]
        out += [g[0], g[1] * layer.spline_scaler.detach()[..., None],
                (g[1] * layer.spline_weight.detach()).sum(-1), *g[2:]]
    return out


def time_b3_b2(params, spec, x0, ts, opts, target, reps):
    """Phase 33's times of B.3 and B.2 at one trajectory, forward and
    backward (each on its own records, the training loss's cotangent), ms
    a call (``cuda_ms``), with the attempts: a dict."""
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_wide as KW

    w = KW.wide_weights(params)
    with torch.no_grad():
        y3, r3 = KW.kanfet_wide_fwd(w, spec.kan, x0, ts, **opts)
        _, r2 = KA.kanfet_adjoint_fwd(params, spec.kan, x0, ts, **opts)
        t3f = cuda_ms(lambda: KW.kanfet_wide_fwd(w, spec.kan, x0, ts,
                                                 **opts), reps)
        t2f = cuda_ms(lambda: KA.kanfet_adjoint_fwd(params, spec.kan, x0, ts,
                                                    **opts), reps)
    ct = 2.0 * (y3 - target) / y3.numel()
    t3b = cuda_ms(lambda: KW.kanfet_wide_bwd(w, spec.kan, x0, ts, r3, ct),
                  reps)
    ct2 = ct.transpose(0, 1).contiguous()
    t2b = cuda_ms(lambda: KA.kanfet_adjoint_bwd(params, spec.kan, x0, ts, r2,
                                                ct2), reps)
    return dict(fwd=t3f, bwd=t3b, b2_fwd=t2f, b2_bwd=t2b,
                n=int(r3.misc[0]), n2=int(r2.n_att[0]))


def wide_phases(device, smi, ts_fit, x0_task):
    """Phases 32-35, the wide predprey stacks: returns the kernel checks,
    the timings and the kernels' launches on the main path."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.models.predprey import (
        WIDE_DISPATCH_FERRO_N,
        PredPreyNODE,
        PredPreyTask,
        lotka_volterra_field,
        max_ferro_n,
        predict,
        trajectory_loss,
        uses_wide_kernel,
    )
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_node as KN
    from fetode_tpu_torch.ops import kanfet_wide as KW
    from fetode_tpu_torch.ops import node_common as NC
    from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(32)
    x0s = {1: x0_task, 3: torch.cat([x0_task, torch.from_numpy(rng.uniform(
        0.5, 2.0, (2, 2)).astype(np.float32)).to(device)])}
    lv = lotka_volterra_field(PredPreyTask())
    targets = {b: odeint_dopri5(lv, x, ts_fit, rtol=1e-8, atol=1e-10,
                                max_steps=2048, mode="while",
                                per_row=True).transpose(0, 1)
               for b, x in x0s.items()}
    preset = PredPreyNODE.kanfet()
    tols = {"preset": dict(rtol=preset.rtol, atol=preset.atol,
                           max_steps=preset.max_steps),
            "loose": dict(WIDE_LOOSE, max_steps=preset.max_steps)}

    # ---- 32. B.3 against plain
    checks = {}
    for layers in WIDE_STACKS:
        spec = PredPreyNODE.kanfet(layers_hidden=layers)
        for regime in ("init", "scaled"):
            params = wide_params(spec, device, regime)
            for B in (1, 3):
                for tol, opts in tols.items():
                    label = (f"kanfet_wide {list(layers)} {regime} B={B} "
                             f"rtol {opts['rtol']:g}")
                    checks[(layers, regime, B, tol)] = check_wide(
                        params, spec.kan, x0s[B], targets[B], ts_fit, opts,
                        label, same_attempts=tol == "loose")

    # ---- 33. B.3 against B.2 at the dispatch boundary, B = 1
    spec = PredPreyNODE.kanfet(layers_hidden=(2, 32, 2))
    params = wide_params(spec, device, "init")
    w = KW.wide_weights(params)
    for tol, opts in tols.items():
        with torch.no_grad():
            y3, r3 = KW.kanfet_wide_fwd(w, spec.kan, x0_task, ts_fit, **opts)
            y2, r2 = KA.kanfet_adjoint_fwd(params, spec.kan, x0_task, ts_fit,
                                           **opts)
        ct = 2.0 * (y3 - targets[1]) / y3.numel()
        g3, xb3 = KW.kanfet_wide_bwd(w, spec.kan, x0_task, ts_fit, r3, ct)
        g2, xb2 = KA.kanfet_adjoint_bwd(params, spec.kan, x0_task, ts_fit,
                                        r2, ct.transpose(0, 1))
        torch.cuda.synchronize()
        n3, n2 = int(r3.misc[0]), int(r2.n_att[0])
        y3 = y3.transpose(0, 1)
        traj = max_abs(y3, y2)
        g_rel = rel_err(flat(module_grads(params, g3)), flat(g2))
        x_rel = rel_err(xb3, xb2)
        line = (f"B.3 vs B.2 [2, 32, 2] B=1 rtol {opts['rtol']:g}: attempts "
                f"{n3} / {n2}; trajectories max |diff| {traj:.3e}; gradients "
                f"on own meshes rel {g_rel:.3e}, x0bar {x_rel:.3e}")
        if tol == "loose":
            if n3 != n2:
                fail(f"{line}: other attempts")
        else:
            if not (torch.allclose(y3, y2, rtol=GRAD_TOL, atol=GRAD_TOL)
                    and g_rel < GRAD_TOL and x_rel < GRAD_TOL):
                fail(f"{line}: beyond 1e-4")
            # B.3's backward on B.2's own mesh.
            g3s, xb3s = KW.kanfet_wide_bwd(w, spec.kan, x0_task, ts_fit,
                                           b2_records_as_traj(r2, 2), ct)
            gs_rel = rel_err(flat(module_grads(params, g3s)), flat(g2))
            xs_rel = rel_err(xb3s, xb2)
            line += (f"; B.3's backward on B.2's mesh: grads rel "
                     f"{gs_rel:.3e}, x0bar {xs_rel:.3e}")
            if not (gs_rel < GRAD_TOL and xs_rel < GRAD_TOL):
                fail(f"{line}: beyond 1e-4")
        print(line)
    # Below the boundary, at the flagship [2, 10, 2] (ferro N = 160, where
    # predict takes B.2): the trajectories at the preset, B = 1.
    spec = PredPreyNODE.kanfet()
    params = wide_params(spec, device, "init")
    opts = tols["preset"]
    with torch.no_grad():
        y3, r3 = KW.kanfet_wide_fwd(KW.wide_weights(params), spec.kan,
                                    x0_task, ts_fit, **opts)
        y2, r2 = KA.kanfet_adjoint_fwd(params, spec.kan, x0_task, ts_fit,
                                       **opts)
    torch.cuda.synchronize()
    traj = max_abs(y3.transpose(0, 1), y2)
    line = (f"B.3 vs B.2 [2, 10, 2] B=1 rtol {opts['rtol']:g}: attempts "
            f"{int(r3.misc[0])} / {int(r2.n_att[0])}; trajectories max "
            f"|diff| {traj:.3e}")
    if not torch.allclose(y3.transpose(0, 1), y2, rtol=GRAD_TOL,
                          atol=GRAD_TOL):
        fail(f"{line}: beyond 1e-4")
    print(line)

    # The B.2 / B.3 crossover over ferro N at B = 1 and the preset: both
    # kernels timed, forward and backward, at N = 160, 512, 4,608, 32,768.
    times, cross = {}, {}
    for layers in CROSS_STACKS:
        spec = PredPreyNODE.kanfet(layers_hidden=layers)
        t = time_b3_b2(wide_params(spec, device, "init"), spec, x0_task,
                       ts_fit, tols["preset"], targets[1],
                       2 if len(layers) > 3 else 5)
        n_ferro = max_ferro_n(spec)
        cross[n_ferro] = t
        print(f"time B.3 / B.2 {list(layers)} (ferro N {n_ferro}) B=1: "
              f"forward {t['fwd']:.4f} / {t['b2_fwd']:.4f} ms, backward "
              f"{t['bwd']:.4f} / {t['b2_bwd']:.4f} ms, attempts {t['n']} / "
              f"{t['n2']} ({smi})")
    wins = [n for n, t in cross.items()
            if t["fwd"] + t["bwd"] < t["b2_fwd"] + t["b2_bwd"]]
    times["crossover"] = cross
    print(f"B.2/B.3 crossover over ferro N at B = 1 (forward + backward): "
          f"B.3 faster at N {sorted(wins)}, B.2 at "
          f"{sorted(set(cross) - set(wins))}; predict's "
          f"WIDE_DISPATCH_FERRO_N = {WIDE_DISPATCH_FERRO_N} ({smi})")

    # ---- 34. a predict training step at [2, 64, 64, 2]
    layers = WIDE_STACKS[-1]
    spec = PredPreyNODE.kanfet(layers_hidden=layers)
    params = wide_params(spec, device, "init")
    w = KW.wide_weights(params)
    n_par = sum(t.numel() for t in w)
    kernels = (KN.kanfet_solve, KA.kanfet_adjoint_fwd, KA.kanfet_adjoint_bwd,
               KW.kanfet_wide_fwd, KW.kanfet_wide_bwd)

    def loss_fn(q, x, tgt):
        return trajectory_loss(q, spec, x, ts_fit, tgt)

    p = copy.deepcopy(params)
    state = init_state(p, make_optimizer(0.0, params=p.parameters(),
                                         grad_clip=1.0))
    step = make_train_step(loss_fn)
    for f in kernels:
        f.launches = 0
    target = targets[1][:, 0]
    step_ms = cuda_ms(lambda: step(state, x0_task[0], target), 3)
    torch.cuda.synchronize()
    counts = [f.launches for f in kernels]
    if counts[:3] != [0, 0, 0] or min(counts[3:]) < 1:
        fail(f"predict step at {list(layers)}: launches (B.1, B.2 fwd, B.2 "
             f"bwd, B.3 fwd, B.3 bwd) {counts}")
    wall, busy, top = profile_ms(lambda: step(state, x0_task[0], target))
    field = KW.wide_field(w, spec.kan)
    with torch.no_grad():
        y1, recs = KW.kanfet_wide_fwd(w, spec.kan, x0_task, ts_fit,
                                      **tols["preset"])
    ct1 = 2.0 * (y1 - targets[1]) / y1.numel()
    with torch.no_grad():
        t = dict(fwd=cuda_ms(lambda: KW.kanfet_wide_fwd(
            w, spec.kan, x0_task, ts_fit, **tols["preset"]), 5),
            plain_fwd=cuda_ms(lambda: NC.record_solve_traj_reference(
                field, x0_task, ts_fit, **tols["preset"]), 1, windows=1))
    t["bwd"] = cuda_ms(lambda: KW.kanfet_wide_bwd(
        w, spec.kan, x0_task, ts_fit, recs, ct1), 5)
    t["plain_bwd"] = cuda_ms(lambda: NC.replay_traj_vjp_reference(
        field, KW.grad_weights(w), x0_task, ts_fit, recs, ct1), 1, windows=1)
    t.update(step=step_ms, wall=wall, busy=busy, n=int(recs.misc[0]),
             bound_fwd=bound(*kanfet_wide_counts(n_par, spec.kan, 1, ts_fit,
                                                 recs, "fwd")),
             bound_bwd=bound(*kanfet_wide_counts(n_par, spec.kan, 1, ts_fit,
                                                 recs, "bwd")))
    times[layers] = t
    print(f"time predict training step {list(layers)} B=1 (forward, backward,"
          f" clip, Adam): {step_ms:.4f} ms; profiled: wall {wall:.4f} ms, "
          f"device busy {busy:.4f} ms ({100 * busy / wall:.1f}%), top "
          f"{[(k, round(v, 4)) for k, v in top]}; launches (B.1, B.2 fwd, "
          f"B.2 bwd, B.3 fwd, B.3 bwd) {counts} ({smi})")
    print(f"time kanfet_wide {list(layers)} B=1: forward {t['fwd']:.4f} ms "
          f"(plain {t['plain_fwd']:.3f}), backward {t['bwd']:.4f} ms (plain "
          f"{t['plain_bwd']:.3f}), {t['n']} attempts; bounds fwd "
          f"{t['bound_fwd'][0]:.5f} ms ({t['bound_fwd'][2]}), bwd "
          f"{t['bound_bwd'][0]:.5f} ms ({t['bound_bwd'][2]}) ({smi})")

    # a stack past B.3's cluster: predict takes B.1 / B.2
    big = PredPreyNODE.kanfet(layers_hidden=WIDE_PAST_CLUSTER)
    if KW.holds(big.kan, 1) or uses_wide_kernel(big):
        fail(f"{list(WIDE_PAST_CLUSTER)}: B.3's cluster holds it")
    bp = wide_params(big, device, "init")
    for f in kernels:
        f.launches = 0
    loss = trajectory_loss(bp, big, x0_task[0], ts_fit, target)
    grads = torch.autograd.grad(loss, list(bp.parameters()))
    torch.cuda.synchronize()
    step_counts = [f.launches for f in kernels]
    with torch.no_grad():
        yk = predict(bp, big, x0_task[0], ts_fit)
        yp = predict(bp, big._replace(solver_mode="while"), x0_task[0],
                     ts_fit)
    torch.cuda.synchronize()
    counts = [f.launches for f in kernels]
    if (step_counts[0] != 0 or min(step_counts[1:3]) < 1
            or step_counts[3:] != [0, 0] or counts[0] != 1
            or counts[1:] != step_counts[1:]
            or not torch.isfinite(loss)
            or not all(bool(torch.isfinite(g).all()) for g in grads)
            or not torch.allclose(yk, yp, rtol=TOL, atol=TOL)):
        fail(f"predict at {list(WIDE_PAST_CLUSTER)}: launches (B.1, B.2 "
             f"fwd, B.2 bwd, B.3 fwd, B.3 bwd) {step_counts} after the "
             f"step, {counts} after the eval, loss {float(loss)}, "
             f"max |diff| {max_abs(yk, yp):.3e} against plain")
    print(f"predict at {list(WIDE_PAST_CLUSTER)} (past B.3's cluster): the "
          f"step's launches (B.1, B.2 fwd, B.2 bwd, B.3 fwd, B.3 bwd) "
          f"{step_counts}, loss {float(loss):.6f}, gradients finite; the "
          f"eval through B.1 within {max_abs(yk, yp):.3e} of plain")

    # ---- 35. the training slice, through the CLI: cli predprey on the
    # widest stack, then cli symbolic
    batches = set()
    undo = log_batches(KW, {"_launch_fwd": 3}, batches)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for f in kernels:
                f.launches = 0
            res = cli.main(["predprey", "--layers", "2,64,64,2", "--device",
                            "cuda", "--epochs", "20", "--epochs_per_call",
                            "10", "--out-dir", tmp])
            torch.cuda.synchronize()
            launches = [f.launches for f in kernels]
            with open(os.path.join(tmp, "metrics.jsonl")) as fh:
                curve = [json.loads(line) for line in fh]
    finally:
        undo()
    losses = [r["train"] for r in curve] + [r["test"] for r in curve]
    if launches[:3] != [0, 0, 0] or min(launches[3:]) < 1:
        fail(f"cli predprey --layers 2,64,64,2: launches (B.1, B.2 fwd, B.2 "
             f"bwd, B.3 fwd, B.3 bwd) {launches}")
    if not np.isfinite(losses).all():
        fail(f"cli predprey --layers 2,64,64,2: non-finite losses {curve}")
    print(f"cli predprey --layers 2,64,64,2 (20 epochs, auto): train "
          f"{[round(r['train'], 6) for r in curve]}, test "
          f"{[round(r['test'], 6) for r in curve]}; "
          f"{res['epochs_per_sec']:.2f} epochs/s; launches (B.1, B.2 fwd, "
          f"B.2 bwd, B.3 fwd, B.3 bwd) {launches}, B.3 batches "
          f"{sorted(b for _, b in batches)} ({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = cli.main(["symbolic", "--device", "cuda", "--out-dir", tmp])
        wall_s = time.perf_counter() - t0
        if not os.path.exists(os.path.join(tmp, "symbolic_trained.npz")):
            fail("cli symbolic wrote no symbolic_trained.npz")
    if not (np.isfinite([res["initial_loss"], res["final_loss"]]).all()
            and res["final_loss"] < res["initial_loss"]):
        fail(f"cli symbolic: losses {res}")
    print(f"cli symbolic (300 epochs, cuda): loss {res['initial_loss']:.4f} "
          f"-> {res['final_loss']:.4f}, {wall_s:.2f} s ({smi})")
    return checks, times, launches[3:]


# ------------------------------------------ ECG recurrent models (B.13)


def ferro_fused_counts(B, P, O, K, state_bytes):
    """(FP32, SFU, bytes) of one B.13 call, each value counted once: per
    term (b, i, o, k) the two crossing sigmoids, the tanhf and about 22
    FP32 operations (the gate arguments, the switch and EMA updates, the
    basis and its weighted sum); per (b, i) the up sigmoid; the K-fold of
    the column sums.  Bytes: x, the state (prev_x, the branch read and the
    new branch written, in the state's type), the five parameter tensors
    and y, each once."""
    terms = B * P * O * K
    fp32 = (terms * (22 + 2 * SIG[0] + TANH[0]) + B * P * (2 + SIG[0])
            + B * O * K)
    sfu = terms * (2 * SIG[1] + TANH[1]) + B * P * SIG[1]
    nbytes = (4 * B * P + state_bytes * (B * P + 2 * terms)
              + 4 * 5 * P * O * K + 4 * B * O)
    return fp32, sfu, nbytes


def bf16_units(a, b):
    """How many bfloat16 values apart a and b (bfloat16 tensors) lie,
    elementwise: the distance of their bit patterns on the line of
    bfloat16 numbers in order (-0 and +0 one point)."""
    def ordinal(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


class plain_ferro_layers:
    """Within it the RNN modules and the symbolic net take the plain
    ``ferro_apply`` where they take B.13 (the comparison runs)."""

    def __enter__(self):
        from fetode_tpu_torch.models import symbolic as SY
        from fetode_tpu_torch.nn import rnn as TR
        from fetode_tpu_torch.ops.ferro import ferro_apply

        self.mods = (TR, SY)
        self.saved = [m.ferro_apply_fused for m in self.mods]
        for m in self.mods:
            m.ferro_apply_fused = ferro_apply
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.mods, self.saved):
            m.ferro_apply_fused = fn


def ferro_state_after(params, cfg, B, n_calls, dtype, device, rng):
    """The state after ``n_calls`` plain calls on random inputs."""
    from fetode_tpu_torch.ops.ferro import ferro_apply, ferro_state_init

    state = ferro_state_init((B,), cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for _ in range(n_calls):
            x = torch.from_numpy(rng.standard_normal(
                (B, cfg.in_dim)).astype(np.float32)).to(device)
            _, state = ferro_apply(params, state, x, cfg)
    return state


def check_ferro_fused(params, cfg, state, x, ybar, label):
    """B.13 against the plain op on one input: y, the new state, and the
    gradients of <y, ybar> through the Function against autograd of the
    plain op.  Returns (max |y diff|, max |branch diff|)."""
    from fetode_tpu_torch.ops import ferro_fused as FF
    from fetode_tpu_torch.ops.ferro import ferro_apply

    weights = [getattr(params, n) for n in FF._NAMES]
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    yk, sk = FF.ferro_apply_fused(params, state, xk, cfg)
    gk = torch.autograd.grad((yk * ybar).sum(), [xk] + weights)
    with torch.no_grad():
        yk2, sk2 = FF.ferro_apply_fused(params, state, x, cfg)
    if not (torch.equal(yk.detach(), yk2)
            and torch.equal(sk.branch, sk2.branch)):
        fail(f"B.13 {label}: y or the new branch differ between two calls")
    yp, sp = ferro_apply(params, state, xp, cfg)
    gp = torch.autograd.grad((yp * ybar).sum(), [xp] + weights)
    torch.cuda.synchronize()
    y_err = max_abs(yk.detach(), yp.detach())
    scale = float(yp.detach().abs().max())
    if not (torch.isfinite(yk).all() and y_err <= 1e-4 + 1e-4 * scale):
        fail(f"B.13 {label}: y max |diff| {y_err:.3e} against max |y| "
             f"{scale:.3e}")
    if sk.branch.dtype != state.branch.dtype or \
            not torch.equal(sk.prev_x, sp.prev_x):
        fail(f"B.13 {label}: the new state's dtype or prev_x differs")
    d = (sk.branch.float() - sp.branch.float()).abs()
    if state.branch.dtype == torch.bfloat16:
        units = bf16_units(sk.branch, sp.branch)
        if int(units.max()) > 1:
            i = int(units.argmax())
            fail(f"B.13 {label}: a bfloat16 branch {int(units.max())} units "
                 f"from plain's rounding: {float(sk.branch.view(-1)[i])} "
                 f"against {float(sp.branch.view(-1)[i])}")
    elif not float(d.max()) <= 1e-5:
        fail(f"B.13 {label}: branch max |diff| {float(d.max()):.3e}")
    g_err = max(rel_err(a, b) for a, b in zip(gk, gp) if b.norm() > 0)
    if not g_err <= 1e-6:
        fail(f"B.13 {label}: gradient rel error {g_err:.3e}")
    return y_err, float(d.max())


def rnn_step_fn(apply, params, x, y):
    """One training step of an RNN classifier (forward, cross-entropy,
    backward, clip and AdamW) at learning rate 0, as a closure."""
    from fetode_tpu_torch.train.ecg_driver import cross_entropy
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    state = init_state(params, make_optimizer(
        0.0, params=params.parameters(), kind="adamw", weight_decay=1e-4,
        grad_clip=1.0))
    step = make_train_step(lambda q, xb, yb: cross_entropy(apply(q, xb), yb))
    return lambda: step(state, x, y)


def rnn_phases(device, smi):
    """Phases 36-39, the ECG recurrent models and B.13: returns the
    kernel's worst y error, its timings and its launches on the CLI
    paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.data.ecg200 import synthetic_ecg200
    from fetode_tpu_torch.models import ecg as M
    from fetode_tpu_torch.nn import rnn as TR
    from fetode_tpu_torch.ops import ferro_fused as FF
    from fetode_tpu_torch.ops.ferro import (
        FerroConfig,
        ferro_apply,
        ferro_init,
        ferro_state_init,
    )
    from fetode_tpu_torch.train.ecg_driver import cross_entropy

    # ---- 36. B.13 against the plain op at every shape its paths give it
    t0 = time.perf_counter()
    rng = np.random.default_rng(36)
    cases = [(s, b) for s in RNN_SHAPES for b in RNN_BATCHES] + \
        [(s, SYM_BATCH) for s in SYM_SHAPES]
    y_worst, n_checks = 0.0, 0
    for shape, B in cases:
        P, O, K = shape
        for gate in ("sigmoid", "tanh"):
            cfg = FerroConfig(P, O, K, gate_impl=gate)
            params = ferro_init(torch.Generator().manual_seed(P + O + K),
                                cfg, device=device)
            for dtype in (torch.float32, torch.bfloat16):
                states = {n: ferro_state_after(params, cfg, B, n, dtype,
                                               device, rng)
                          for n in (0, 1, RNN_T)}
                for n, state in states.items():
                    x = torch.from_numpy(rng.standard_normal(
                        (B, P)).astype(np.float32)).to(device)
                    ybar = torch.from_numpy(rng.standard_normal(
                        (B, O)).astype(np.float32)).to(device)
                    label = (f"({P}->{O}, K={K}) B={B} {gate} "
                             f"{str(dtype)[6:]} after {n} calls")
                    y_err, _ = check_ferro_fused(params, cfg, state, x, ybar,
                                                 label)
                    y_worst = max(y_worst, y_err)
                    n_checks += 1
    # update_branch=False returns the old branch
    cfg = FerroConfig(64, 64, 12, update_branch=False)
    params = ferro_init(torch.Generator().manual_seed(1), cfg, device=device)
    state = ferro_state_after(params, cfg._replace(update_branch=True), 8, 1,
                              torch.float32, device, rng)
    with torch.no_grad():
        _, s1 = FF.ferro_apply_fused(params, state, torch.zeros(
            (8, 64), device=device), cfg)
    if s1.branch is not state.branch:
        fail("B.13 with update_branch=False did not return the old branch")
    print(f"B.13 against plain ferro_apply, the same bits twice: {n_checks} "
          f"cases (shapes "
          f"{list(RNN_SHAPES) + list(SYM_SHAPES)}, B {RNN_BATCHES} / "
          f"{SYM_BATCH}, fresh / 1 / {RNN_T} calls of state, float32 and "
          f"bfloat16 state, both gates): y max |diff| {y_worst:.3e}, "
          f"branch within 1e-5 (bfloat16: one unit), prev_x equal, "
          f"gradients within 1e-6; {time.perf_counter() - t0:.1f} s")

    # ---- 37. the sequence paths, kernel against plain, at full width
    t0 = time.perf_counter()
    data = synthetic_ecg200()
    series = np.concatenate([data[0], data[2]])
    labels = np.concatenate([data[1], data[3]])
    fcfg = TR.FerroKANRNNConfig(hidden_size=64, num_basis=12)
    nspec = M.NodeRNNSpec(hidden_size=64, num_basis=12)
    models = {
        "fepa_rnn": (TR.ferro_kan_rnn_init(torch.Generator().manual_seed(0),
                                           fcfg, device=device),
                     lambda p, x: TR.ferro_kan_rnn_apply(p, fcfg, x),
                     2 * series.shape[1] + 1, (8, 64)),
        "node_rnn": (M.node_rnn_init(torch.Generator().manual_seed(0), nspec,
                                     device=device),
                     lambda p, x: M.node_rnn_apply(p, nspec, x),
                     4 * nspec.n_steps + 2, (8, 32))}
    seq_errs = {}
    for name, (params, apply, per_fwd, batches) in models.items():
        for B in batches:
            x = torch.from_numpy(series[:B].astype(np.float32)).to(device)
            y = torch.from_numpy(labels[:B]).long().to(device)
            FF.ferro_apply_fused.launches = 0
            with torch.no_grad():
                lk = apply(params, x)
            torch.cuda.synchronize()
            if FF.ferro_apply_fused.launches != per_fwd:
                fail(f"{name} B={B}: {FF.ferro_apply_fused.launches} B.13 "
                     f"launches a forward, not {per_fwd}")
            gk = torch.autograd.grad(cross_entropy(apply(params, x), y),
                                     list(params.parameters()),
                                     allow_unused=True)
            with plain_ferro_layers():
                with torch.no_grad():
                    lp = apply(params, x)
                gp = torch.autograd.grad(cross_entropy(apply(params, x), y),
                                         list(params.parameters()),
                                         allow_unused=True)
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(gk, gp) if b is not None]
            l_err = max_abs(lk, lp) / float(lp.abs().max())
            g_err = rel_err(flat([a for a, _ in pairs]),
                            flat([b for _, b in pairs]))
            if not (torch.isfinite(lk).all() and l_err <= 1e-4
                    and g_err <= 1e-4):
                fail(f"{name} B={B}: logits rel {l_err:.3e}, loss gradient "
                     f"rel {g_err:.3e} (limit 1e-4)")
            seq_errs[(name, B)] = (l_err, g_err)
            print(f"{name} B={B}, kernel against plain: logits rel "
                  f"{l_err:.3e}, loss gradient rel {g_err:.3e}; {per_fwd} "
                  f"B.13 launches a forward")
    print(f"phase 37: {time.perf_counter() - t0:.1f} s")

    # ---- 38. the CLI paths
    t0 = time.perf_counter()
    launches = {}
    batches = set()
    undo = log_batches(FF, {"_launch": 0}, batches)
    try:
        runs = {
            "ecg fepa_rnn": ["ecg", "--model", "fepa_rnn", "--epochs", "2"],
            "ecg node_rnn": ["ecg", "--model", "node_rnn", "--epochs", "2"],
            "ecg fepa_rnn noisy": ["ecg", "--model", "fepa_rnn", "--epochs",
                                   "2", "--noise_std", "0.2"],
            "ecg digital_rnn": ["ecg", "--model", "digital_rnn", "--epochs",
                                "2"],
            "ecg all": ["ecg", "--model", "all", "--epochs", "1"],
            "ett kan_fet_diffusion": ["ett", "--model", "kan_fet_diffusion",
                                      "--epochs", "1"],
            "symbolic": ["symbolic"]}
        for label, argv in runs.items():
            with tempfile.TemporaryDirectory() as tmp:
                FF.ferro_apply_fused.launches = 0
                t1 = time.perf_counter()
                res = cli.main(argv + ["--device", "cuda", "--out-dir", tmp])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                launches[label] = FF.ferro_apply_fused.launches
            if label == "symbolic":
                losses = [res["initial_loss"], res["final_loss"]]
            elif label.startswith("ett"):
                losses = res["train_curve"] + res["val_curve"] + \
                    [res["test_mse"]]
            elif label == "ecg all":
                losses = sum(res["loss_curves"].values(), [])
            else:
                losses = res["loss_curve"]
            if not np.isfinite(losses).all():
                fail(f"cli {label}: non-finite losses {losses}")
            print(f"cli {label} (cuda): {wall:.2f} s, B.13 launches "
                  f"{launches[label]}, "
                  + (f"best test acc {res['best_test_acc']}"
                     if label.startswith("ecg") else f"losses {losses}")
                  + f" ({smi})")
    finally:
        undo()
    for label in ("ecg fepa_rnn", "ecg node_rnn", "symbolic"):
        if launches[label] < 1:
            fail(f"cli {label} launched no B.13 kernel")
    if launches["ecg fepa_rnn noisy"] != 0:
        fail("cli ecg fepa_rnn --noise_std 0.2 launched B.13, which has no "
             "noise operand")
    print(f"B.13 launches by CLI path {launches}; the noisy fepa_rnn "
          f"launches none by design (device noise takes the plain op); "
          f"batches launched {sorted(b for _, b in batches)}; phase 38 "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 39. times, CUDA events, median of 3 windows
    t0 = time.perf_counter()
    times = {}
    for shape in list(RNN_SHAPES) + list(SYM_SHAPES):
        P, O, K = shape
        cfg = FerroConfig(P, O, K)
        params = ferro_init(torch.Generator().manual_seed(2), cfg,
                            device=device)
        for B in (8, 64):
            state = ferro_state_after(params, cfg, B, 1, torch.float32,
                                      device, rng)
            x = torch.from_numpy(rng.standard_normal((B, P)).astype(
                np.float32)).to(device)
            with torch.no_grad():
                def kern():
                    return FF.ferro_apply_fused(params, state, x, cfg)

                def plain():
                    return ferro_apply(params, state, x, cfg)
                row = dict(
                    ms=queued_ms(kern), wall=cuda_ms(kern, 50),
                    plain=queued_ms(plain, n=10),
                    plain_wall=cuda_ms(plain, 20),
                    bound=bound(*ferro_fused_counts(B, P, O, K, 4)))
            times[(shape, B)] = row
            print(f"time B.13 ({P}->{O}, K={K}) B={B}: kernel {row['ms']:.4f}"
                  f" device ms ({row['wall']:.4f} ms a call back to back), "
                  f"plain {row['plain']:.4f} device ms ({row['plain_wall']:.4f}"
                  f" ms a call), bound {row['bound'][0]:.5f} ms "
                  f"({row['bound'][2]}) ({smi})")
    x8 = torch.from_numpy(series[:8].astype(np.float32)).to(device)
    y8 = torch.from_numpy(labels[:8]).long().to(device)
    dcfg = TR.DigitalRNNConfig(hidden_size=64)
    steps = {
        "fepa_rnn": (models["fepa_rnn"][0], models["fepa_rnn"][1]),
        "node_rnn": (models["node_rnn"][0], models["node_rnn"][1]),
        "digital_rnn": (TR.digital_rnn_init(torch.Generator().manual_seed(0),
                                            dcfg, device=device),
                        lambda p, x: TR.digital_rnn_apply(p, dcfg, x))}
    for name, (params, apply) in steps.items():
        reps = 1 if name == "node_rnn" else 3     # node_rnn: about 1 s a step
        fn = rnn_step_fn(apply, copy.deepcopy(params), x8, y8)
        step_ms = cuda_ms(fn, reps)
        wall, busy, top = profile_ms(fn, n=reps)
        row = dict(step=step_ms, wall=wall, busy=busy)
        msg = ""
        if name != "digital_rnn":
            with plain_ferro_layers():
                row["plain_step"] = cuda_ms(rnn_step_fn(
                    apply, copy.deepcopy(params), x8, y8), reps)
            msg = f", with the plain op {row['plain_step']:.2f} ms"
        times[name] = row
        print(f"time {name} training step B=8 (forward, backward, clip, "
              f"AdamW, lr 0): {step_ms:.3f} ms{msg}; profiled: wall "
              f"{wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}%), top "
              f"{[(k, round(v, 4)) for k, v in top]} ({smi})")
    print(f"phase 39: {time.perf_counter() - t0:.1f} s")
    return y_worst, times, sum(launches.values())


# ------------------------------------- B.12 and B.14 (phases 40-43)

# Every B.12 launch's (rows, in, out, knots, order) over the run, and the
# B.12 launches of each main-path run (the count set to 0 just before it
# and read just after).
SPLINE_LOG = set()
SPLINE_RUNS = {}


def log_spline_shapes():
    """Wrap B.12's launcher so that every launch records its shape in
    ``SPLINE_LOG``, which phase 40 checks; it counts nothing."""
    from fetode_tpu_torch.ops import spline as SP

    launch = SP._launch

    def logged(x, grid, weight, order):
        SPLINE_LOG.add((x.shape[0], x.shape[1], weight.shape[0],
                        grid.shape[1], int(order)))
        return launch(x, grid, weight, order)
    SP._launch = logged


def count_spline(label, fn):
    """``fn()``, a main-path run, with B.12's count set to 0 just before it
    and read just after into ``SPLINE_RUNS[label]``."""
    from fetode_tpu_torch.ops import spline as SP

    SP.spline_matmul_fused.launches = 0
    out = fn()
    torch.cuda.synchronize()
    SPLINE_RUNS[label] = SPLINE_RUNS.get(label, 0) + \
        SP.spline_matmul_fused.launches
    return out


class plain_spline:
    """Within it the KAN layers take the plain spline product where they
    take B.12 (the comparison runs of phase 43)."""

    def __enter__(self):
        from fetode_tpu_torch.models import cond_diffusion as CD
        from fetode_tpu_torch.nn import kan as TK
        from fetode_tpu_torch.ops.spline import spline_matmul_reference

        self.mods = (TK, CD)
        self.saved = [m.spline_matmul_fused for m in self.mods]
        for m in self.mods:
            m.spline_matmul_fused = spline_matmul_reference
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.mods, self.saved):
            m.spline_matmul_fused = fn


def bspline_window_counts(n_knots=12, order=3):
    """(FP32 per point, FP32 per feature, SFU per feature) of the nonzero
    B-spline columns of one value, the least the function needs: the knot
    interval m found by two range compares and a binary search over the
    n_knots - 1 intervals; the ``order`` differences x - g_j, j = m -
    order + 1 .. m, that the weights w_j = (x - g_j) r_jk of the window
    read; per level k the k weights (a product each), their k complements
    1 - w, the 2 k products and k - 1 sums of the window's k + 1 terms (5
    k - 1); the reciprocals r_jk = 1 / (g_j+k - g_j) once a feature, as
    ``bspline_counts`` counts them."""
    search = 2 + math.ceil(math.log2(n_knots - 1))
    per = search + order + sum(5 * k - 1 for k in range(1, order + 1))
    _, per_feat, sfu_feat = bspline_counts(n_knots, order)
    return per, per_feat, sfu_feat


def spline_counts(R, I, O, n_knots=12, order=3):
    """(FP32, SFU, bytes) of one B.12 call, each value counted once: the
    product's 2 R I C O, the nonzero bases of every (row, input) as
    ``bspline_window_counts`` counts them; x, the knots, the weight and y
    moved once."""
    C = n_knots - 1 - order
    per, per_feat, sfu_feat = bspline_window_counts(n_knots, order)
    return (2 * R * I * C * O + R * I * per + I * per_feat, I * sfu_feat,
            4 * (R * I + I * n_knots + O * I * C + R * O))


def custom_field_counts(B, D, H, recs, kind):
    """(FP32, SFU, bytes) of a B.14 kernel call: an evaluation is the two
    products and B H tanhs; a VJP recomputes the hidden layer, forms zbar
    (the w w2 product) and the three products gw2, gw1, ubar."""
    ev = (4 * B * H * D + B * H * TANH[0], B * H * TANH[1])
    vjp = (B * H * (4 * D + TANH[0] + 3) + 6 * B * D * H, B * H * TANH[1])
    return node_counts(ev, vjp, 2 * H * D, 0, B, D, recs, kind)


def spline_layer(device, rng, R, I, O, sl=None, n_knots=12, order=3):
    """Inputs of one B.12 call as a layer gives them: x (R, I) ~ 1.2 N(0,
    1) (some of it past the grid's end knots), the knot rows, and a layer's
    spline weight ~ N(0, 1) (O, W, C) and scaler ~ U(-1, 1) / sqrt(W) (O,
    W), W = I unless the inputs are the columns sl = (start, W) of a
    wider layer; ``term(fn, x, w, s)`` is the spline term through ``fn``
    on the scaled weight's column slice as it lies."""
    from fetode_tpu_torch.ops.bsplines import make_grid

    start, width = sl if sl else (0, I)
    C = n_knots - 1 - order
    grid = make_grid(width, n_knots - 2 * order - 1, order,
                     device=device)[start:start + I]

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)
    x = t(1.2 * rng.standard_normal((R, I)))
    w = t(rng.standard_normal((O, width, C)))
    s = t(rng.uniform(-1.0, 1.0, (O, width)) / np.sqrt(width))

    def term(fn, x, w, s):
        return fn(x, grid, (w * s[..., None])[:, start:start + I, :], order)
    return x, w, s, grid, term


def check_spline(device, rng, R, I, O, sl=None, n_knots=12, order=3,
                 full=False):
    """Phase 40 at one shape: B.12 against plain within SPLINE_TOL, the
    same bits twice; with ``full``, rows 0, R/2 and R-1 alone the same bits
    as inside the batch, and the gradients of x, the spline weight and the
    scaler through autograd within SPLINE_GRAD_TOL of autograd of plain.
    Returns (max |y diff|, gradient rel error or None)."""
    from fetode_tpu_torch.ops import spline as SP

    label = f"B.12 R={R} {I}->{O}" + (f" (columns {sl[0]}.. of {sl[1]})"
                                      if sl else "")
    x, w, s, grid, term = spline_layer(device, rng, R, I, O, sl, n_knots,
                                       order)
    fused, plain = SP.spline_matmul_fused, SP.spline_matmul_reference
    with torch.no_grad():
        y, y2 = term(fused, x, w, s), term(fused, x, w, s)
        yp = term(plain, x, w, s)
    torch.cuda.synchronize()
    err = max_abs(y, yp)
    if not (torch.isfinite(y).all() and torch.allclose(
            y, yp, rtol=SPLINE_TOL, atol=SPLINE_TOL)):
        fail(f"{label}: max |diff| {err:.3e} against plain")
    if not torch.equal(y, y2):
        fail(f"{label}: two calls differ")
    g_err = None
    if full:
        with torch.no_grad():
            for r in sorted({0, R // 2, R - 1}):
                if not torch.equal(term(fused, x[r:r + 1], w, s), y[r:r + 1]):
                    fail(f"{label}: row {r} alone differs from the batch")
        ct = torch.from_numpy(rng.standard_normal((R, O)).astype(
            np.float32)).to(device)

        def grads(fn):
            leaves = [a.clone().requires_grad_(True) for a in (x, w, s)]
            return torch.autograd.grad((term(fn, *leaves) * ct).sum(),
                                       leaves)
        g_err = max(rel_err(a, b) for a, b in zip(grads(fused),
                                                  grads(plain)))
        if not g_err <= SPLINE_GRAD_TOL:
            fail(f"{label}: gradient rel error {g_err:.3e}")
    return err, g_err


def check_spline_edges(device):
    """B.12 on inputs off the grid and on its end knots (half-open
    intervals): against plain, and rows with no input inside the grid
    exactly zero."""
    from fetode_tpu_torch.ops import spline as SP
    from fetode_tpu_torch.ops.bsplines import make_grid

    rng = np.random.default_rng(41)
    grid = make_grid(256, 5, 3, device=device)
    first, last = float(grid[0, 0]), float(grid[0, -1])
    vals = np.array([-5.0, first, last, 5.0, 0.3, -0.999], np.float32)
    x = torch.from_numpy(vals[rng.integers(0, 6, (16, 256))]).to(device)
    x[:4] = torch.from_numpy(np.array([-5.0, last, 5.0], np.float32)[
        rng.integers(0, 3, (4, 256))]).to(device)
    w = torch.from_numpy(rng.standard_normal((256, 256, 8)).astype(
        np.float32)).to(device) / 16.0
    with torch.no_grad():
        y = SP.spline_matmul_fused(x, grid, w, 3)
        yp = SP.spline_matmul_reference(x, grid, w, 3)
    torch.cuda.synchronize()
    err = max_abs(y, yp)
    if not (torch.isfinite(y).all() and torch.allclose(
            y, yp, rtol=SPLINE_TOL, atol=SPLINE_TOL)):
        fail(f"B.12 off the grid / on its end knots: max |diff| {err:.3e}")
    if not torch.equal(y[:4], torch.zeros_like(y[:4])):
        fail("B.12: rows with every input off the grid or on its last knot "
             "are not zero")
    # a NaN or infinite input: plain's bases are NaN from order 1 on (its
    # row of y NaN), zero at order 0
    bad = x.clone()
    bad[4, 3], bad[5, 100], bad[6, 255] = float("nan"), float("inf"), \
        -float("inf")
    for order, g, wo in ((3, grid, w), (0, grid[:, :9], w)):
        with torch.no_grad():
            y = SP.spline_matmul_fused(bad, g, wo, order)
            yp = SP.spline_matmul_reference(bad, g, wo, order)
        torch.cuda.synchronize()
        nan_rows = torch.isnan(yp).any(dim=1)
        if not (torch.equal(torch.isnan(y), torch.isnan(yp))
                and bool(nan_rows[4:7].all()) == (order >= 1)
                and torch.allclose(y[~nan_rows], yp[~nan_rows],
                                   rtol=SPLINE_TOL, atol=SPLINE_TOL)):
            fail(f"B.12 order {order} with NaN and infinite inputs: NaN rows "
                 f"{torch.isnan(y).any(dim=1).nonzero().flatten().tolist()}, "
                 f"plain's {nan_rows.nonzero().flatten().tolist()}")
        err = max(err, max_abs(y[~nan_rows], yp[~nan_rows]))
    return err


def custom_case(device, D, H, scale, seed, opts=CUSTOM_OPTS):
    """B.14's kernels on weights w1 ~ scale N(0, 1) (H, D) and w2 ~ scale'
    N(0, 1) (D, H) as closures (the ``check_node_kernels`` /
    ``time_node_kernels`` contract); ``scale`` None takes 1/sqrt(fan-in)."""
    from fetode_tpu_torch.examples import custom_field_kernel as CF

    g = torch.Generator().manual_seed(seed)
    s1, s2 = (scale, scale) if scale else (D ** -0.5, H ** -0.5)
    w = [(s1 * torch.randn((H, D), generator=g)).to(device).requires_grad_(),
         (s2 * torch.randn((D, H), generator=g)).to(device).requires_grad_()]
    solve = CF.make_my_solver(D, H, **opts)
    return dict(
        name=f"custom_field D={D} H={H}",
        fwd=lambda h0, record=True: CF.custom_field_fwd(*w, h0, record=record,
                                                        **opts),
        bwd=lambda h0, recs, hbar: CF.custom_field_bwd(*w, h0, recs, hbar),
        solve=lambda h0: solve(*w, h0), weights=w,
        counts=lambda B, recs, kind: custom_field_counts(B, D, H, recs,
                                                         kind),
        **final_state_plain(CF.tanh_mlp_field(*w), w, opts))


def check_custom_more(case, h0, hbar, label):
    """Phase 41 beyond ``check_node_kernels``: the time reached (misc[1],
    as JAX's misc[0, 1]) is the last attempt's t + dt if it was accepted,
    else its t, and plain's within 1e-4 relative (the step sizes follow the
    error estimate, which float32 sums in another order move at its
    rounding: a few 1e-6 after 3 attempts on the chip); the backward the
    same bits in two calls."""
    with torch.no_grad():
        _, rk = case["fwd"](h0)
        _, rp = case["plain_fwd"](h0)
    got = [case["bwd"](h0, rk, hbar) for _ in range(2)]
    torch.cuda.synchronize()
    n = int(rk.misc[0])
    dt, acc, t = rk.tda[n - 1, :3].tolist()
    reached = float(np.float32(t) + np.float32(dt) * np.float32(acc))
    t_k, t_p = float(rk.misc[1]), float(rp.misc[1])
    if n != int(rp.misc[0]) or t_k != reached or \
            abs(t_k - t_p) > 1e-4 * abs(t_p):
        fail(f"{label}: attempts / end time {[n, t_k]} (its records: "
             f"{reached}) against plain's {rp.misc[:2].tolist()}")
    if not all(torch.equal(a, b) for a, b in zip(
            got[0][0] + [got[0][1]], got[1][0] + [got[1][1]])):
        fail(f"{label}: the backward kernel's gradients differ between two "
             "calls")
    return n, t_k


def spline_steps(device):
    """Phase 42's training steps (learning rate 0, as closures that return
    (state, loss)): cond_diffusion ``kan_node`` and ``kan_fet_all_node`` at
    B = 64, MNIST ``pallas`` at 128, ETT ``kan_diffusion`` at 64."""
    from fetode_tpu_torch.models import cond_diffusion as CD
    from fetode_tpu_torch.models import forecasting as F
    from fetode_tpu_torch.models import kuramoto as TK
    from fetode_tpu_torch.nn.diffusion import make_schedule
    from fetode_tpu_torch.train import cond_diffusion_driver as drv
    from fetode_tpu_torch.train.loop import init_state, make_train_step
    from fetode_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(42)

    def step(params, loss, *batch):
        state = init_state(params, make_optimizer(
            0.0, params=params.parameters(), kind="adamw", weight_decay=1e-4,
            grad_clip=1.0))
        fn = make_train_step(loss)
        return lambda: fn(state, *batch)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    steps = {}
    cw = cond_windows()
    sched = make_schedule(250, device=device)
    for name in ("kan_node", "kan_fet_all_node"):
        spec = CD.make_denoiser_spec(name, d_in=cw.shape[2], pred_len=24)
        params = CD.cond_denoiser_init(torch.Generator().manual_seed(0), spec,
                                       device=device)

        def loss(q, xb, yb, spec=spec):
            g = torch.Generator(device=device).manual_seed(0)
            return drv.cond_diffusion_loss(q, spec, sched, xb, yb, g)
        steps[f"cond_diffusion {name} B=64"] = step(
            params, loss, t(cw[:64]), t(rng.standard_normal((64, 24, 7))))
    kspec = TK.KuramotoSpec(rollout="pallas")
    kparams = TK.kuramoto_init(torch.Generator().manual_seed(0), kspec,
                               device=device)
    case = kuramoto_case(device, 128, 3)
    steps["mnist pallas B=128"] = mnist_step_fn(kparams, kspec, case["x"],
                                                case["y"], "pallas")
    fw = forecast_windows()
    dspec = F.DiffusionForecasterSpec(num_features=fw.shape[2], diff_T=200,
                                      encoder="kan", solver_mode="pallas")
    dparams = F.diffusion_forecaster_init(torch.Generator().manual_seed(0),
                                          dspec, device=device)
    dsched = make_schedule(dspec.diff_T, device=device)

    def dloss(q, xb, yb):
        g = torch.Generator(device=device).manual_seed(0)
        return F.diffusion_forecaster_loss(q, dspec, dsched, xb, yb, g)
    steps["ett kan_diffusion B=64"] = step(
        dparams, dloss, t(fw[:64]), t(rng.standard_normal(
            (64, dspec.pred_len))))
    return steps


def spline_custom_phases(device, smi):
    """Phases 40-43, B.12 and B.14: returns the kernels' worst errors, their
    timings and their launches on the main paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.examples import custom_field_kernel as CF
    from fetode_tpu_torch.ops import spline as SP
    from fetode_tpu_torch.ops.bsplines import bspline_basis
    from fetode_tpu_torch.serve import load_servable

    # ---- 40. B.12 against plain at every shape its paths launch
    t0 = time.perf_counter()
    path_shapes = set(SPLINE_LOG)       # launched by phases 3-39
    rng = np.random.default_rng(40)
    checked, g_worst = {}, 0.0
    for R, I, O, sl in SPLINE_SHAPES:
        err, g_err = check_spline(device, rng, R, I, O, sl, full=True)
        checked[(R, I, O, 12, 3)] = err
        g_worst = max(g_worst, g_err)
    seen = sorted(path_shapes - set(checked))
    for R, I, O, nk, order in seen:
        checked[(R, I, O, nk, order)] = check_spline(device, rng, R, I, O,
                                                     None, nk, order)[0]
    layers = sorted({(I, O, sl) for _, I, O, sl in SPLINE_SHAPES},
                    key=str)
    multi = {}
    for I, O, sl in layers:
        multi[(I, O)] = check_spline(device, rng, SPLINE_MULTI_ROWS, I, O, sl,
                                     full=True)[0]
    groups = {(I, O): SP._lib().spline_matmul_groups(I, 12, 3)
              for I, O, _ in layers}
    print(f"B.12 at R = {SPLINE_MULTI_ROWS} (several row tiles and clusters)"
          f" on {len(layers)} layers, input groups (cluster CTAs) {groups}: "
          f"y max |diff| {max(multi.values()):.3e}, the same bits twice, "
          f"rows 0, R/2 and R-1 alone as in the batch, gradients within "
          f"{SPLINE_GRAD_TOL}")
    edge_err = check_spline_edges(device)
    print(f"B.12 against plain: {len(SPLINE_SHAPES)} path shapes with the "
          f"row and gradient checks (gradients rel <= {g_worst:.3e}), "
          f"{len(seen)} more launched by phases 3-39 "
          f"{[s[:3] for s in seen]}: y max |diff| "
          f"{max(checked.values()):.3e} (limit rtol = atol = {SPLINE_TOL}), "
          f"the same bits twice, a row alone as in its batch; off the grid "
          f"and on its end knots {edge_err:.3e}, all-off rows zero, NaN "
          f"and infinite inputs' rows NaN as plain's; "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 41. B.14 against plain, and the example
    t0 = time.perf_counter()
    rng = np.random.default_rng(41)
    custom = {}
    for (D, H, B), scale in [(CUSTOM_SMALL, 0.5)] + [
            ((*CUSTOM_DH, b), None) for b in CUSTOM_BATCHES]:
        case = custom_case(device, D, H, scale, seed=B)
        h0 = torch.from_numpy(rng.standard_normal((B, D)).astype(
            np.float32)).to(device)
        hbar = torch.from_numpy(rng.standard_normal((B, D)).astype(
            np.float32)).to(device)
        res = check_node_kernels(case, h0, hbar)
        att, t_end = check_custom_more(case, h0, hbar, f"{case['name']} B={B}")
        custom[(D, H, B)] = dict(res, case=case, h0=h0, hbar=hbar)
        print(f"  {case['name']} B={B}: attempts {att}, end time {t_end} "
              f"(plain's within 1e-4); the backward the same bits twice")
    # an attempt budget the solve runs out of: the end time plain reaches
    D, H = CUSTOM_DH
    short = dict(CUSTOM_OPTS, max_steps=3)
    case = custom_case(device, D, H, 2.0 / np.sqrt(D), seed=5, opts=short)
    h0 = torch.from_numpy(rng.standard_normal((64, D)).astype(
        np.float32)).to(device)
    res = check_node_kernels(case, h0, h0, backward=False)
    att, t_end = check_custom_more(case, h0, h0, "custom_field max_steps=3")
    if not t_end < 1.0:
        fail(f"custom_field max_steps=3 reached t = {t_end}: the budget was "
             "meant to run out")
    print(f"  custom_field max_steps=3 B=64: stops at t = {t_end} after "
          f"{att} attempts, as its records and plain say")
    # the example, in this process (its launches counted) and as a user
    # runs it
    import contextlib
    import io

    CF.custom_field_fwd.launches = CF.custom_field_bwd.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CF.main([])
    torch.cuda.synchronize()
    custom_launches = (CF.custom_field_fwd.launches,
                       CF.custom_field_bwd.launches)
    print(buf.getvalue(), end="")
    verified = "custom-field whole-solve kernel: forward + adjoint verified"
    if rc != 0 or buf.getvalue().strip().splitlines()[-1] != verified or \
            min(custom_launches) < 1:
        fail(f"the custom-field example: rc {rc}, launches {custom_launches}")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "fetode_tpu_torch.examples.custom_field_kernel"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=300)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or last != verified:
        fail(f"python -m fetode_tpu_torch.examples.custom_field_kernel: rc "
             f"{proc.returncode}, last line {last!r}: {proc.stderr[-2000:]}")
    print(f"python -m fetode_tpu_torch.examples.custom_field_kernel: "
          f"{last!r}; in this process B.14 launches (fwd, bwd) "
          f"{custom_launches}; phase 41 {time.perf_counter() - t0:.1f} s")

    # ---- 42. the paths through B.12: serving through the CLI, and a
    # training step of each KAN model
    t0 = time.perf_counter()
    mark = set(SPLINE_LOG)
    cw = cond_windows()

    def xs(b, off=0):
        return torch.from_numpy(cw[(off + np.arange(b)) % len(cw)]).to(device)
    reqs = {b: xs(b, 7 * b) for b in (1, 30, 300)}
    serve_argv = ["serve", "--source", "cond_diffusion", "--device", "cuda",
                  "--buckets", "8,64,256", "--iters", str(SERVE_ITERS)]
    rows = set()
    with tempfile.TemporaryDirectory() as tmp:
        undo = log_batches(SP, {"_launch": 0}, rows)
        try:
            sres = count_spline("serve cond_diffusion",
                                lambda: cli.main(serve_argv + ["--out-dir",
                                                               tmp]))
        finally:
            undo()
        cfg_s = make_config("serve", cli._parse(serve_argv)[1])
        sparams, sfn, _ = cli.SERVING["cond_diffusion"](cfg_s, device)
        sv = load_servable(sres["bundle"], sfn, sparams)
        served = count_spline("serve cond_diffusion requests", lambda: {
            b: sv.predict(x) for b, x in reqs.items()})
        check_served(sv, sfn, reqs, served, "serve cond_diffusion (B.12)")
    rows = {b for _, b in rows}
    if not set(SPLINE_SERVE_ROWS) <= rows:
        fail(f"serve cond_diffusion launched B.12 at rows {sorted(rows)}, "
             f"not in every bucket {SPLINE_SERVE_ROWS}")
    print(f"serve cond_diffusion (kan_node): B.12 launches "
          f"{SPLINE_RUNS['serve cond_diffusion']} (rows {sorted(rows)}), "
          f"requests B=1/30/300 {SPLINE_RUNS['serve cond_diffusion requests']}"
          f" = direct calls on the padded batches")
    steps = spline_steps(device)
    for name, fn in steps.items():
        _, loss = count_spline(f"step {name}", fn)
        if not (torch.isfinite(loss) and SPLINE_RUNS[f"step {name}"] > 0):
            fail(f"step {name}: loss {float(loss)}, B.12 launches "
                 f"{SPLINE_RUNS[f'step {name}']}")
        print(f"step {name}: loss {float(loss):.5f}, B.12 launches "
              f"{SPLINE_RUNS[f'step {name}']}")
    for label in ("cli ett --model kan_diffusion", "cli mnist --rollout pallas",
                  "cli cond_diffusion --denoiser kan_node",
                  "cli cond_diffusion --denoiser kan_fet_all_node",
                  "serve cond_diffusion (phase 26)"):
        if SPLINE_RUNS.get(label, 0) < 1:
            fail(f"{label} launched no B.12 kernel")
    new = sorted(SPLINE_LOG - mark - set(checked))
    for R, I, O, nk, order in new:
        checked[(R, I, O, nk, order)] = check_spline(device, rng, R, I, O,
                                                     None, nk, order)[0]
    print(f"B.12 launches by main-path run {SPLINE_RUNS}; shapes first "
          f"launched in phase 42, checked against plain now: "
          f"{[s[:3] for s in new]}; phase 42 {time.perf_counter() - t0:.1f} s")

    # ---- 43. times
    t0 = time.perf_counter()
    times = {}
    rng = np.random.default_rng(43)
    for R, I, O, sl in SPLINE_TIMED:
        x, w, s, grid, term = spline_layer(device, rng, R, I, O, sl)
        with torch.no_grad():
            sw = (w * s[..., None])[:, sl[0]:sl[0] + I, :] if sl else \
                w * s[..., None]
            bases = bspline_basis(x, grid, 3).reshape(R, -1)
            w2 = sw.reshape(O, -1)

            def kern():
                return SP.spline_matmul_fused(x, grid, sw, 3)

            def plain():
                return SP.spline_matmul_reference(x, grid, sw, 3)

            def mm():
                return torch.matmul(bases, w2.T)
            row = dict(ms=queued_ms(kern), wall=cuda_ms(kern, 50),
                       plain=queued_ms(plain), plain_wall=cuda_ms(plain, 20),
                       matmul=queued_ms(mm),
                       bound=bound(*spline_counts(R, I, O)))
        times[(R, I, O)] = row
        print(f"time B.12 R={R} {I}->{O}: kernel {row['ms']:.4f} device ms "
              f"({row['wall']:.4f} ms a call back to back), plain "
              f"{row['plain']:.4f} device ms ({row['plain_wall']:.4f} ms a "
              f"call), torch.matmul of the product alone on precomputed "
              f"bases {row['matmul']:.4f} device ms (queued_ms); bound "
              f"{row['bound'][0]:.5f} ms ({row['bound'][2]}) ({smi})")
    c = custom[(*CUSTOM_DH, 64)]
    times["custom"] = time_node_kernels(c["case"], c["h0"], c["hbar"], smi)

    with tempfile.TemporaryDirectory() as tmp:
        with plain_spline():
            pres = count_spline("serve cond_diffusion, plain product",
                                lambda: cli.main(serve_argv + ["--out-dir",
                                                               tmp]))
    if SPLINE_RUNS["serve cond_diffusion, plain product"]:
        fail("the plain-product serve launched B.12")
    times["serve"] = {}
    for r12, rp in zip(sres["bench"], pres["bench"]):
        times["serve"][r12["batch"]] = (r12, rp)
        print(f"serve cond_diffusion bucket {r12['batch']}: with B.12 p50 "
              f"{r12['p50_ms']:.4f} ms, p99 {r12['p99_ms']:.4f} ms; with the "
              f"plain product p50 {rp['p50_ms']:.4f} ms, p99 "
              f"{rp['p99_ms']:.4f} ms ({smi})")
    times["steps"] = {}
    for name, fn in steps.items():
        ms = cuda_ms(fn, 5)
        wall, busy, top = profile_ms(fn, n=3)
        with plain_spline():
            plain_ms = cuda_ms(fn, 5)
        times["steps"][name] = dict(ms=ms, plain=plain_ms, busy=busy,
                                    wall=wall)
        print(f"time step {name} (lr 0): with B.12 {ms:.4f} ms, with the "
              f"plain product {plain_ms:.4f} ms; profiled: wall {wall:.4f} "
              f"ms, device busy {busy:.4f} ms ({100 * busy / wall:.1f}%), "
              f"top {[(k, round(v, 4)) for k, v in top]} ({smi})")
    print(f"phase 43: {time.perf_counter() - t0:.1f} s")
    errs = dict(spline=max(max(checked.values()), max(multi.values()),
                           edge_err),
                custom_fwd=max(c["fwd_err"] for c in custom.values()),
                custom_bwd=max(c["g_abs"] for c in custom.values()))
    launches = dict(spline=sum(SPLINE_RUNS.values()),
                    custom_fwd=custom_launches[0],
                    custom_bwd=custom_launches[1])
    return errs, times, launches


# ------------------------------- B.1 / B.2 on other stacks (phase 44)


def stack_target(x0s, ts, lv):
    """A training target for a stack of state size D: the Lotka-Volterra
    truth from x0s' first two components, and 1 in any further one."""
    from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5

    truth = odeint_dopri5(lv, x0s[:, :2].contiguous(), ts, rtol=1e-8,
                          atol=1e-10, max_steps=2048, mode="while",
                          per_row=True)
    extra = torch.ones(truth.shape[:2] + (x0s.shape[1] - 2,),
                       dtype=truth.dtype, device=truth.device)
    return torch.cat([truth, extra], dim=-1)


def check_attempts(r_k, r_p, same, label):
    """Phase 32's attempt contract on B.2's forward records ``r_k``
    against the plain recording solve's ``r_p``, row by row: at
    ``WIDE_LOOSE`` (``same``) plain's attempts; at the preset within
    ``WIDE_ATTEMPTS`` of them (at least 3) and the same time reached.
    Returns the worst gap and the most attempts."""
    n_k, n_p = r_k.n_att.cpu().numpy(), r_p.n_att.cpu().numpy()
    t_k, t_p = r_k.t_end.cpu().numpy(), r_p.t_end.cpu().numpy()
    gap = np.abs(n_k - n_p)
    if same and gap.max() > 0:
        fail(f"{label}: attempts kernel {n_k.tolist()}, plain {n_p.tolist()}")
    n_tol = np.maximum(3, np.ceil(WIDE_ATTEMPTS * n_p))
    if (gap > n_tol).any() or (np.abs(t_k - t_p) > 1e-6 * np.abs(t_p)).any():
        fail(f"{label}: attempts kernel {n_k.tolist()} to t = {t_k.tolist()}, "
             f"plain {n_p.tolist()} to t = {t_p.tolist()}")
    return int(gap.max()), int(n_k.max())


def timed(fn):
    """(fn's result, its ms): one call between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def check_stack(params, spec, x0s, ts, ts_fit, target, wide, label):
    """Phase 44 at one stack: B.1 against plain on the first N_CHECK
    serving times; B.2's forward against plain; its backward on its own
    records twice (the same bits) against autograd of the plain replay of
    them, relative < GRAD_TOL as phase 6, and where that misses, against
    the float64 plain replay under phase 32's GRAD_CAP rule; the full
    gradient against plain's, each on its own mesh; for a wide stack,
    phase 32's attempt contract.  The plain versions wait on the device
    at every step (the while solve tests which rows still run), so they
    cannot queue: their times are these calls' own (CUDA events).
    Returns the errors, the kernel's records and the plain times."""
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_node as KN

    cfg = spec.kan
    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    with torch.no_grad():
        y1 = KN.kanfet_solve(params, cfg, x0s, ts, **kw)
        y1p, plain_serve = timed(lambda: KN.kanfet_solve_reference(
            params, cfg, x0s, ts, **kw))
        y2, r_k = KA.kanfet_adjoint_fwd(params, cfg, x0s, ts_fit, **kw)
        (y2p, r_p), plain_fwd = timed(lambda: KA.record_attempts_reference(
            params, cfg, x0s, ts_fit, **kw))
    if not all(torch.isfinite(y).all() for y in (y1, y1p, y2, y2p)):
        fail(f"{label}: non-finite forward output")
    serve_err = max_abs(y1[:, :N_CHECK], y1p[:, :N_CHECK])
    fwd_err = max_abs(y2, y2p)
    if not (torch.allclose(y1[:, :N_CHECK], y1p[:, :N_CHECK], rtol=TOL,
                           atol=TOL)
            and torch.allclose(y2, y2p, rtol=TOL, atol=TOL)):
        fail(f"{label}: forward kernels disagree with plain (B.1 "
             f"{serve_err:.3e}, B.2 {fwd_err:.3e})")
    ct = 2.0 * (y2 - target) / y2.numel()
    got = [KA.kanfet_adjoint_bwd(params, cfg, x0s, ts_fit, r_k, ct)
           for _ in range(2)]
    torch.cuda.synchronize()
    (g_k, xb_k), (g_k2, xb_k2) = got
    if not all(torch.isfinite(g).all() for g in g_k + [xb_k]):
        fail(f"{label}: non-finite kernel gradients")
    if not all(torch.equal(a, b) for a, b in zip(g_k + [xb_k],
                                                 g_k2 + [xb_k2])):
        fail(f"{label}: the backward kernel's gradients differ between two "
             "calls")
    (g_p, xb_p), plain_bwd = timed(lambda: KA.replay_vjp_reference(
        params, cfg, x0s, ts_fit, r_k, ct))
    g_rel, x_rel = rel_err(flat(g_k), flat(g_p)), rel_err(xb_k, xb_p)
    g_abs = max(max_abs(flat(g_k), flat(g_p)), max_abs(xb_k, xb_p))
    against = "plain"
    g_tol = x_tol = GRAD_TOL
    if not (g_rel < g_tol and x_rel < x_tol):
        # Phase 32's rule: against the float64 plain replay, a number that
        # misses 1e-4 held to 4x the float32 replay's own error, at most
        # GRAD_CAP.
        p64 = copy.deepcopy(params).double()
        r64 = KA.AttemptRecords(r_k.rec.double(), r_k.n_att,
                                r_k.t_end.double())
        g_64, xb_64 = KA.replay_vjp_reference(p64, cfg, x0s.double(),
                                              ts_fit.double(), r64,
                                              ct.double())
        g_rel = rel_err(flat(g_k).double(), flat(g_64))
        x_rel = rel_err(xb_k.double(), xb_64)
        if not g_rel < g_tol:
            g_tol = min(GRAD_CAP, max(g_tol, 4 * rel_err(
                flat(g_p).double(), flat(g_64))))
        if not x_rel < x_tol:
            x_tol = min(GRAD_CAP, max(x_tol, 4 * rel_err(
                xb_p.double(), xb_64)))
        g_abs = max(max_abs(flat(g_k).double(), flat(g_64)),
                    max_abs(xb_k.double(), xb_64))
        against = "float64 plain (GRAD_CAP rule)"
    if not (g_rel < g_tol and x_rel < x_tol):
        fail(f"{label}: backward kernel vs {against} replay on the kernel's "
             f"mesh: grads rel {g_rel:.3e} (bound {g_tol:.1e}), x0bar rel "
             f"{x_rel:.3e} (bound {x_tol:.1e})")

    def full(solve):
        weights = KA.train_weights(params)
        loss = torch.mean((solve(params, cfg, x0s, ts_fit, **kw) - target)
                          ** 2)
        return flat(torch.autograd.grad(loss, weights))

    gk, gp = full(KA.kanfet_solve_train), full(KA.kanfet_solve_train_reference)
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    if not cos > COS_MIN:
        fail(f"{label}: own-mesh gradient cosine {cos:.6f}")
    line = (f"{label}: B.1 vs plain max |diff| {serve_err:.3e} (first "
            f"{N_CHECK} of {ts.shape[0]} times); B.2 forward {fwd_err:.3e}, "
            f"attempts {int(r_k.n_att.min())}..{int(r_k.n_att.max())}; "
            f"backward vs {against} replay on the kernel's mesh: grads rel "
            f"{g_rel:.3e} (bound {g_tol:.1e}), x0bar rel {x_rel:.3e} (bound "
            f"{x_tol:.1e}), the same bits twice; own-mesh cosine {cos:.7f}")
    if wide:
        opts = dict(WIDE_LOOSE, max_steps=spec.max_steps)
        with torch.no_grad():
            _, l_k = KA.kanfet_adjoint_fwd(params, cfg, x0s, ts_fit, **opts)
            _, l_p = KA.record_attempts_reference(params, cfg, x0s, ts_fit,
                                                  **opts)
        loose = check_attempts(l_k, l_p, True, f"{label} rtol 1e-3")
        preset = check_attempts(r_k, r_p, False, f"{label} preset")
        line += (f"; attempts at rtol 1e-3 as plain's (up to {loose[1]}), "
                 f"at the preset within {preset[0]} of plain's (up to "
                 f"{preset[1]})")
    print(line)
    return dict(serve_err=serve_err, fwd_err=fwd_err, g_rel=g_rel,
                x_rel=x_rel, cos=cos, recs=r_k, ct=ct, g_abs=g_abs,
                plain_serve=plain_serve, plain_fwd=plain_fwd,
                plain_bwd=plain_bwd)


def check_global_placement(device, rng, ts, ts_fit, lv):
    """Phase 44: the flagship at B = 8 with the warps' scratch and the
    backward's gradients in global memory (where stacks past 227 KB of
    scratch or gradients put them), against the default placement, all in
    shared memory: the same kernel code, so B.1, B.2's forward and x0bar
    the same bits; the gradients summed in another order (a row a warp,
    not a block), within 1e-6 relative."""
    from fetode_tpu_torch.models.predprey import PredPreyNODE, predprey_init
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_node as KN

    spec = PredPreyNODE.kanfet()
    params = predprey_init(torch.Generator().manual_seed(0), spec,
                           device=device)
    x0s = torch.from_numpy(rng.uniform(0.5, 2.0, (8, 2)).astype(
        np.float32)).to(device)
    target = stack_target(x0s, ts_fit, lv)
    kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)

    walk0 = KN.stack_geometry

    def forced_global(cfg):
        geo = walk0(cfg)
        geo["fwd"] = dict(geo["fwd"], scratch=False)
        geo["bwd"] = dict(geo["bwd"], scratch=False, grads=False)
        for kind in ("fwd", "bwd"):
            geo[kind]["bytes"] = 4 * geo["n_params"]
        return geo

    runs = []
    for walk in (walk0, forced_global):
        # Both wrappers look the placement up where it is defined.
        saved = KN.stack_geometry, KA.stack_geometry
        KN.stack_geometry = KA.stack_geometry = walk
        try:
            with torch.no_grad():
                y1 = KN.kanfet_solve(params, spec.kan, x0s, ts, **kw)
                y2, recs = KA.kanfet_adjoint_fwd(params, spec.kan, x0s,
                                                 ts_fit, **kw)
            ct = 2.0 * (y2 - target) / y2.numel()
            g, xb = KA.kanfet_adjoint_bwd(params, spec.kan, x0s, ts_fit,
                                          recs, ct)
            runs.append((y1, y2, flat(g), xb))
        finally:
            KN.stack_geometry, KA.stack_geometry = saved
    torch.cuda.synchronize()
    (a1, a2, ag, ax), (b1, b2, bg, bx) = runs
    g_rel = rel_err(bg, ag)
    if not (torch.equal(a1, b1) and torch.equal(a2, b2)
            and torch.equal(ax, bx) and g_rel < 1e-6):
        fail(f"global placement at [2, 10, 2] B=8 differs from shared: "
             f"outputs equal {torch.equal(a1, b1)}, {torch.equal(a2, b2)}; "
             f"x0bar equal {torch.equal(ax, bx)}; grads rel {g_rel:.3e}")
    print(f"[2, 10, 2] B=8 with the warp scratch and gradients in global "
          f"memory: forwards and x0bar the same bits as in shared memory, "
          f"gradients rel {g_rel:.3e}")


def stack_phases(device, smi, ts_fit):
    """Phase 44, B.1 and B.2 on the pure-KANFET stacks of ``STACKS_44``:
    the kernel checks, the CLI and the trajectory driver on two of them,
    and the times; returns the launches of B.1, B.2's forward and
    backward on those two paths."""
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.models.predprey import (
        PredPreyNODE,
        PredPreyTask,
        lotka_volterra_field,
        predprey_init,
    )
    from fetode_tpu_torch.nn.kan import kanfet_config
    from fetode_tpu_torch.ops import kanfet_adjoint as KA
    from fetode_tpu_torch.ops import kanfet_node as KN
    from fetode_tpu_torch.train.traj_driver import (
        TrajParallelRun,
        train_traj_parallel,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(44)
    lv = lotka_volterra_field(PredPreyTask())
    ts = torch.linspace(0.0, HORIZON, T_SERVE, dtype=torch.float32,
                        device=device)
    for layers, grid, order, B in STACKS_44:
        t1 = time.perf_counter()
        spec = PredPreyNODE(kan=kanfet_config(list(layers), grid_size=grid,
                                              spline_order=order))
        params = predprey_init(torch.Generator().manual_seed(0), spec,
                               device=device)
        D = layers[0]
        x0s = torch.from_numpy(rng.uniform(0.5, 2.0, (B, D)).astype(
            np.float32)).to(device)
        target = stack_target(x0s, ts_fit, lv)
        geo = KN.stack_geometry(spec.kan)
        label = (f"{list(layers)} grid {grid} order {order} B={B} "
                 f"(parameters in "
                 f"{'shared' if geo['fwd']['params'] else 'global'} memory, "
                 f"gradients {'shared' if geo['bwd']['grads'] else 'global'})")
        c = check_stack(params, spec, x0s, ts, ts_fit, target,
                        layers in STACKS_44_WIDE, label)
        kw = dict(rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
        with torch.no_grad():
            _, serve_recs = KA.kanfet_adjoint_fwd(params, spec.kan, x0s, ts,
                                                  **kw)
            t = dict(
                serve=queued_ms(lambda: KN.kanfet_solve(
                    params, spec.kan, x0s, ts, **kw), n=2, windows=2),
                fwd=queued_ms(lambda: KA.kanfet_adjoint_fwd(
                    params, spec.kan, x0s, ts_fit, **kw), n=2, windows=2))
        t["bwd"] = queued_ms(lambda: KA.kanfet_adjoint_bwd(
            params, spec.kan, x0s, ts_fit, c["recs"], c["ct"]), n=2,
            windows=2)
        t.update({k: c[k] for k in ("plain_serve", "plain_fwd",
                                    "plain_bwd")})
        b_serve = bound(*kanfet_counts(params, spec.kan, serve_recs, T_SERVE,
                                       "serve"))
        b_fwd = bound(*kanfet_counts(params, spec.kan, c["recs"],
                                     ts_fit.shape[0], "fwd"))
        b_bwd = bound(*kanfet_counts(params, spec.kan, c["recs"],
                                     ts_fit.shape[0], "bwd"))
        print(f"time {list(layers)} grid {grid} order {order} B={B}: B.1 "
              f"{t['serve']:.4f} "
              f"ms (plain {t['plain_serve']:.3f}, bound {b_serve[0]:.5f}, "
              f"{int(serve_recs.n_att.max())} attempts), B.2 forward "
              f"{t['fwd']:.4f} ms (plain {t['plain_fwd']:.3f}, bound "
              f"{b_fwd[0]:.5f}), backward {t['bwd']:.4f} ms (plain "
              f"{t['plain_bwd']:.3f}, bound {b_bwd[0]:.5f}); "
              f"{time.perf_counter() - t1:.1f} s ({smi})")
    check_global_placement(device, rng, ts, ts_fit, lv)
    print(f"phase 44 checks and times: {time.perf_counter() - t0:.1f} s")

    kernels = (KN.kanfet_solve, KA.kanfet_adjoint_fwd, KA.kanfet_adjoint_bwd)
    with tempfile.TemporaryDirectory() as tmp:
        for f in kernels:
            f.launches = 0
        cli.main(["predprey", "--device", "cuda", "--solver_mode", "pallas",
                  "--layers", "2,4,4,2", "--grid_size", "7", "--epochs",
                  "20", "--epochs_per_call", "10", "--out-dir", tmp])
        torch.cuda.synchronize()
        cli_launches = [f.launches for f in kernels]
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            curve = [json.loads(line) for line in fh]
    losses = [r["train"] for r in curve] + [r["test"] for r in curve]
    if min(cli_launches) < 1 or not np.isfinite(losses).all():
        fail(f"cli predprey --layers 2,4,4,2 --grid_size 7: launches (B.1, "
             f"B.2 fwd, B.2 bwd) {cli_launches}, losses {curve}")
    print(f"cli predprey --layers 2,4,4,2 --grid_size 7 (20 epochs, pallas): "
          f"train {[round(r['train'], 6) for r in curve]}, test "
          f"{[round(r['test'], 6) for r in curve]}; launches (B.1, B.2 fwd, "
          f"B.2 bwd) {cli_launches} ({smi})")
    for f in kernels:
        f.launches = 0
    _, hist = train_traj_parallel(TrajParallelRun(
        n_traj=8, epochs=2, epochs_per_call=1,
        spec=PredPreyNODE.kanfet(layers_hidden=(2, 24, 24, 2),
                                 solver_mode="pallas")), log=None)
    torch.cuda.synchronize()
    traj_launches = [f.launches for f in kernels]
    if min(traj_launches[1:]) < 1 or not np.isfinite(hist["train"]).all():
        fail(f"train_traj_parallel [2, 24, 24, 2]: launches (B.1, B.2 fwd, "
             f"B.2 bwd) {traj_launches}, losses {hist['train']}")
    print(f"train_traj_parallel [2, 24, 24, 2] (8 trajectories, 2 epochs, "
          f"pallas): losses {hist['train']}; launches (B.1, B.2 fwd, B.2 "
          f"bwd) {traj_launches} ({smi})")
    print(f"phase 44: {time.perf_counter() - t0:.1f} s")
    return [a + b for a, b in zip(cli_launches, traj_launches)]


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fetode_tpu_torch import cli
    from fetode_tpu_torch.config import make_config
    from fetode_tpu_torch.models.predprey import (
        PredPreyNODE,
        PredPreyTask,
        generate_data,
        lotka_volterra_field,
        predprey_init,
        trajectory_loss,
    )
    from fetode_tpu_torch.nn.kan import KAN
    from fetode_tpu_torch.ops import _build
    from fetode_tpu_torch.ops.kanfet_adjoint import (
        kanfet_adjoint_bwd,
        kanfet_adjoint_fwd,
    )
    from fetode_tpu_torch.ops.kanfet_node import (
        kanfet_solve,
        kanfet_solve_reference,
    )
    from fetode_tpu_torch.serve import load_servable
    from fetode_tpu_torch.solvers.dopri5 import odeint_dopri5
    from fetode_tpu_torch.train.traj_driver import (
        TrajParallelRun,
        train_traj_parallel,
    )
    from fetode_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")

    # ---- 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, so in zip(KERNELS, built):
        _build.load_library(name)
        print(f"built {so.name} ({time.perf_counter() - t0:.1f}s for all)")
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")
    log_spline_shapes()

    # ---- 3. kernel against plain on the card
    spec = PredPreyNODE.kanfet()
    params = predprey_init(torch.Generator().manual_seed(0), spec,
                           device=device)
    rng = np.random.default_rng(0)
    x0s = torch.from_numpy(rng.uniform(0.5, 2.0, (256, 2)).astype(np.float32)
                           ).to(device)
    ts = torch.linspace(0.0, HORIZON, T_SERVE, dtype=torch.float32,
                        device=device)
    kw = dict(rtol=spec.rtol, atol=spec.atol)
    with torch.no_grad():
        out_k = kanfet_solve(params, spec.kan, x0s, ts,
                             max_steps=spec.max_steps, **kw)
        torch.cuda.synchronize()
        out_r = kanfet_solve_reference(params, spec.kan, x0s, ts,
                                       max_steps=spec.max_steps, **kw)
    yk, yr = out_k.cpu().numpy(), out_r.cpu().numpy()
    if yk.shape != (x0s.shape[0], T_SERVE, 2) or not np.isfinite(yk).all():
        fail(f"kernel output shape {yk.shape} or non-finite values")
    if not np.isfinite(yr).all():
        fail("plain output has non-finite values")
    max_abs_err = float(np.abs(yk - yr).max())
    err40 = float(np.abs(yk[:, :N_CHECK] - yr[:, :N_CHECK]).max())
    print(f"kernel vs plain, B=256, T={T_SERVE}: max |diff| {max_abs_err:.3e} "
          f"(first {N_CHECK} points: {err40:.3e})")
    if not np.allclose(yk[:, :N_CHECK], yr[:, :N_CHECK], rtol=TOL, atol=TOL):
        fail(f"kernel disagrees with plain on the first {N_CHECK} points")

    # max_steps=8: every row runs out of attempts.  At rtol 1e-7 the f32
    # error estimate of the first step sits at its rounding floor, so two
    # correct implementations reach slightly different times within 8
    # attempts (the JAX package's own kernel and eager solve differ there
    # too).  Both must stop early; the points both reached must agree.
    with torch.no_grad():
        yk8 = kanfet_solve(params, spec.kan, x0s, ts, max_steps=8,
                           **kw).cpu().numpy()
        yr8 = kanfet_solve_reference(params, spec.kan, x0s, ts, max_steps=8,
                                     **kw).cpu().numpy()
    fk, fr = frontier(yk8), frontier(yr8)
    if not (np.isfinite(yk8).all() and (fk < T_SERVE).all()
            and (fr < T_SERVE).all()):
        fail("max_steps=8: a trajectory did not stop early or is not finite")
    both = np.arange(T_SERVE)[None, :] < np.minimum(fk, fr)[:, None]
    err8 = float(np.abs(yk8 - yr8)[both].max()) if both.any() else 0.0
    print(f"max_steps=8: frontier kernel {fk.min()}..{fk.max()}, plain "
          f"{fr.min()}..{fr.max()}, max |diff| where both reached {err8:.3e}")
    if not np.allclose(yk8[both], yr8[both], rtol=TOL, atol=TOL):
        fail("max_steps=8: kernel disagrees with plain where both reached")

    # ---- 4. the slice, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["serve", "--source", "predprey", "--solver_mode", "pallas",
                "--device", "cuda", "--buckets", "8,64,256",
                "--out-dir", tmp]
        kanfet_solve.launches = 0
        result = cli.main(argv)
        cfg = make_config("serve", cli._parse(argv)[1])
        _, fn, _ = cli.predprey_serving(cfg, device)
        sv = load_servable(result["bundle"], fn, KAN(spec.kan, device=device))
        requests = {b: torch.from_numpy(
            rng.uniform(0.5, 2.0, (b, 2)).astype(np.float32)).to(device)
            for b in (1, 100, 300)}
        served = {b: sv.predict(x) for b, x in requests.items()}
        torch.cuda.synchronize()
        launches = kanfet_solve.launches
        if launches < 1:
            fail("the served path launched no kanfet_node kernel")
        with torch.no_grad():
            for b, x in requests.items():
                direct = fn(sv.params, x)
                if served[b].shape != (b, T_SERVE, 2) or \
                        not torch.equal(served[b], direct):
                    fail(f"request B={b}: served output differs from a "
                         "direct kernel call")
                if not torch.isfinite(served[b]).all():
                    fail(f"request B={b}: non-finite output")
    print(f"served B=1/100/300 through the bundle = direct kernel calls; "
          f"{launches} kernel launches on the main path")
    for row in result["bench"]:
        print(f"  serve bucket {row['batch']}: p50 {row['p50_ms']:.3f} ms, "
              f"p99 {row['p99_ms']:.3f} ms, window p50s "
              f"{['%.3f' % w for w in row['window_p50_ms']]}")

    # ---- 5. timing, kernel and plain
    times = {}
    with torch.no_grad():
        for b in (8, 64, 256):
            xb = x0s[:b].contiguous()
            ms = cuda_ms(lambda: kanfet_solve(params, spec.kan, xb, ts,
                                              max_steps=spec.max_steps, **kw),
                         reps=20)
            plain = cuda_ms(lambda: kanfet_solve_reference(
                params, spec.kan, xb, ts, max_steps=spec.max_steps, **kw),
                reps=1)
            times[b] = (ms, plain)
            print(f"time B={b}: kernel {ms:.4f} ms, plain {plain:.3f} ms "
                  f"({smi})")

    # ---- 6. training kernels against plain
    task = PredPreyTask()
    ts_fit = torch.linspace(0.0, task.tf_learn, task.n_train,
                            dtype=torch.float32, device=device)
    lv = lotka_volterra_field(task)
    x0_task = torch.tensor([[task.x0, task.y0]], dtype=torch.float32,
                           device=device)
    batches = {256: x0s, 1: x0_task}
    targets = {b: odeint_dopri5(lv, x, ts_fit, rtol=1e-8, atol=1e-10,
                                max_steps=2048, mode="while", per_row=True)
               for b, x in batches.items()}
    checks = {b: check_training_kernels(params, spec, x, ts_fit, targets[b])
              for b, x in batches.items()}

    # ---- 7. the training slice, through the CLI and the traj driver
    _, ts_learn, truth = generate_data(task, device=device)
    with torch.no_grad():
        loss0 = float(trajectory_loss(params, spec, x0_task[0], ts_learn,
                                      truth[:task.n_train]))
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for f in (kanfet_solve, kanfet_adjoint_fwd, kanfet_adjoint_bwd):
            f.launches = 0
        result = cli.main(["predprey", "--device", "cuda", "--solver_mode",
                           "pallas", "--epochs", "200", "--epochs_per_call",
                           "100", "--out-dir", tmp])
        torch.cuda.synchronize()
        counts["predprey"] = (kanfet_solve.launches,
                              kanfet_adjoint_fwd.launches,
                              kanfet_adjoint_bwd.launches)
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            curve = [json.loads(line) for line in fh]
    train = [row["train"] for row in curve] + [result["final_train"]]
    tests = [row["test"] for row in curve]
    if not np.isfinite(train + tests).all():
        fail(f"cli predprey: non-finite losses {train} / {tests}")
    if not result["final_train"] < loss0:
        fail(f"cli predprey: loss did not fall: {loss0} -> "
             f"{result['final_train']}")
    print(f"cli predprey (200 epochs, pallas): loss {loss0:.6f} at init -> "
          f"{[round(v, 6) for v in train[:-1]]}; test {tests}; "
          f"{result['epochs_per_sec']:.2f} epochs/s ({smi})")

    for f in (kanfet_solve, kanfet_adjoint_fwd, kanfet_adjoint_bwd):
        f.launches = 0
    _, hist = train_traj_parallel(TrajParallelRun(
        n_traj=256, epochs=20, epochs_per_call=10,
        spec=PredPreyNODE.kanfet(solver_mode="pallas")), log=None)
    torch.cuda.synchronize()
    counts["traj"] = (kanfet_solve.launches, kanfet_adjoint_fwd.launches,
                      kanfet_adjoint_bwd.launches)
    if not (np.isfinite(hist["train"]).all()
            and hist["train"][-1] < hist["train"][0]):
        fail(f"train_traj_parallel: losses not finite or not falling: "
             f"{hist['train']}")
    print(f"train_traj_parallel (256 trajectories, 20 epochs, pallas): "
          f"losses {hist['train']}; {hist['epochs_per_sec']:.2f} epochs/s, "
          f"{hist['traj_epochs_per_sec']:.1f} traj-epochs/s ({smi})")
    serve_launches = launches + counts["predprey"][0] + counts["traj"][0]
    fwd_launches = counts["predprey"][1] + counts["traj"][1]
    bwd_launches = counts["predprey"][2] + counts["traj"][2]
    print(f"launches (serving, adjoint fwd, adjoint bwd): cli predprey "
          f"{counts['predprey']}, traj driver {counts['traj']}")
    if min(counts["predprey"][1:] + counts["traj"][1:]) < 1:
        fail("a training path did not launch both training kernels")

    # ---- 8. timing of a training step, kernels and plain
    step_times = {b: time_training(params, spec, x, ts_fit, targets[b], smi)
                  for b, x in batches.items()}

    ecg_checks, ecg_times, ecg_launches = ecg_phases(device, smi)
    ode_checks, ddpm_errs, ett_times, ett_launches = forecast_phases(device,
                                                                     smi)
    kura_checks, kura_errs, kura_times, kura_launches = kuramoto_phases(
        device, smi)
    enc_checks, enc_times, enc_launches = cond_diffusion_phases(device, smi)
    mlp_checks, mlp_times, mlp_launches = mlp_phases(device, smi)
    wide_checks, wide_times, wide_launches = wide_phases(device, smi,
                                                         ts_fit, x0_task)
    ff_err, ff_times, ff_launches = rnn_phases(device, smi)
    sc_errs, sc_times, sc_launches = spline_custom_phases(device, smi)
    stack_launches = stack_phases(device, smi, ts_fit)
    serve_launches += stack_launches[0]
    fwd_launches += stack_launches[1]
    bwd_launches += stack_launches[2]

    # ---- the kernels line: predprey at B = 256, ECG at B = 8, the latent
    # solve at the training batch 64, the chain at 2,560 rows, the Kuramoto
    # rollout at the training batch 128, the fused classifier at the
    # largest serving bucket, 256, the node encoder at the training batch
    # 64, the 'mlp' field at the training batch 8, the wide stack [2, 64,
    # 64, 2] at its training batch, 1, the ferro layer op at the
    # FEPA-RNN's hidden shape (64 -> 64, K = 12) and training batch, 8, the
    # spline term at the serving chain's 256 -> 256 layer in bucket 256
    # (2,560 rows), and the custom field at D = 64, H = 128, B = 64
    ot, dt = ett_times[("ode_dyn", 64)], ett_times[("ddpm", 2560)]
    with torch.no_grad():
        _, serve_recs = kanfet_adjoint_fwd(params, spec.kan, x0s, ts,
                                           max_steps=spec.max_steps, **kw)
    lt, ft = ecg_times[("logistic", 8)], ecg_times[("ferro", 8)]
    kt, kl = kura_times[128], kura_times[256]
    et, mt = enc_times[64], mlp_times[8]
    wt = wide_times[WIDE_STACKS[-1]]
    ff = ff_times[(RNN_SHAPES[1], 8)]
    st, ct = sc_times[(2560, 256, 256)], sc_times["custom"]

    def worst(model, key):
        return max(c[key] for k, c in ecg_checks.items()
                   if k[0].split()[0] == model)
    print(json.dumps({"kernels": [
        kernel_entry("kanfet_node_solve", "fetode_tpu_torch/csrc/kanfet_node.cu",
                     "fetode_tpu/ops/pallas_node.py:260",
                     serve_launches, max_abs_err, times[256][0],
                     times[256][1], bound(*kanfet_counts(
                         params, spec.kan, serve_recs, T_SERVE, "serve"))),
        kernel_entry("kanfet_adjoint_fwd",
                     "fetode_tpu_torch/csrc/kanfet_adjoint.cu",
                     "fetode_tpu/ops/pallas_adjoint.py:863", fwd_launches,
                     checks[256][0], step_times[256]["kernel"]["fwd"],
                     step_times[256]["plain"]["fwd"], bound(*kanfet_counts(
                         params, spec.kan, checks[256][4], ts_fit.shape[0],
                         "fwd"))),
        kernel_entry("kanfet_adjoint_bwd",
                     "fetode_tpu_torch/csrc/kanfet_adjoint.cu",
                     "fetode_tpu/ops/pallas_adjoint.py:932", bwd_launches,
                     checks[256][5], step_times[256]["kernel"]["bwd"],
                     step_times[256]["plain"]["bwd"], bound(*kanfet_counts(
                         params, spec.kan, checks[256][4], ts_fit.shape[0],
                         "bwd"))),
        kernel_entry("logistic_node_fwd",
                     "fetode_tpu_torch/csrc/logistic_node.cu",
                     "fetode_tpu/ops/pallas_logistic_node.py:121",
                     ecg_launches[0], worst("logistic", "fwd_err"),
                     lt["fwd"], lt["plain_fwd"], lt["bound_fwd"]),
        kernel_entry("logistic_node_bwd",
                     "fetode_tpu_torch/csrc/logistic_node.cu",
                     "fetode_tpu/ops/pallas_logistic_node.py:141",
                     ecg_launches[1], worst("logistic", "g_abs"),
                     lt["bwd"], lt["plain_bwd"], lt["bound_bwd"]),
        kernel_entry("ferro_node_fwd", "fetode_tpu_torch/csrc/ferro_node.cu",
                     "fetode_tpu/ops/pallas_ferro_node.py:475",
                     ecg_launches[2], worst("ferro", "fwd_err"),
                     ft["fwd"], ft["plain_fwd"], ft["bound_fwd"]),
        kernel_entry("ferro_node_bwd", "fetode_tpu_torch/csrc/ferro_node.cu",
                     "fetode_tpu/ops/pallas_ferro_node.py:505",
                     ecg_launches[3], worst("ferro", "g_abs"),
                     ft["bwd"], ft["plain_bwd"], ft["bound_bwd"]),
        kernel_entry("ode_dyn_fwd", "fetode_tpu_torch/csrc/ode_dyn.cu",
                     "fetode_tpu/ops/pallas_ode_dyn.py:173", ett_launches[0],
                     max(c["fwd_err"] for c in ode_checks.values()),
                     ot["fwd"], ot["plain_fwd"], ot["bound_fwd"]),
        kernel_entry("ode_dyn_bwd", "fetode_tpu_torch/csrc/ode_dyn.cu",
                     "fetode_tpu/ops/pallas_ode_dyn.py:192", ett_launches[1],
                     max(c["g_abs"] for c in ode_checks.values()
                         if "g_abs" in c),
                     ot["bwd"], ot["plain_bwd"], ot["bound_bwd"]),
        kernel_entry("ddpm_chain", "fetode_tpu_torch/csrc/ddpm.cu",
                     "fetode_tpu/ops/pallas_ddpm.py:160", ett_launches[2],
                     max(ddpm_errs.values()), dt["ms"], dt["plain"],
                     dt["bound"]),
        kernel_entry("kuramoto_fwd", "fetode_tpu_torch/csrc/kuramoto.cu",
                     "fetode_tpu/ops/pallas_kuramoto.py:241",
                     kura_launches[0],
                     max(c["fwd_err"] for c in kura_checks.values()),
                     kt["fwd"], kt["plain_fwd"], kt["bound_fwd"]),
        kernel_entry("kuramoto_bwd", "fetode_tpu_torch/csrc/kuramoto.cu",
                     "fetode_tpu/ops/pallas_kuramoto.py:261",
                     kura_launches[1],
                     max(c["g_abs"] for c in kura_checks.values()),
                     kt["bwd"], kt["plain_bwd"], kt["bound_bwd"]),
        kernel_entry("kuramoto_logits", "fetode_tpu_torch/csrc/kuramoto.cu",
                     "fetode_tpu/ops/pallas_kuramoto.py:471",
                     kura_launches[2], max(kura_errs.values()),
                     kl["logits"], kl["plain_logits"], kl["bound_logits"]),
        kernel_entry("node_enc_fwd", "fetode_tpu_torch/csrc/node_enc.cu",
                     "fetode_tpu/ops/pallas_node_enc.py:196",
                     enc_launches[0],
                     max(c["fwd_err"] for c in enc_checks.values()),
                     et["fwd"], et["plain_fwd"], et["bound_fwd"]),
        kernel_entry("node_enc_bwd", "fetode_tpu_torch/csrc/node_enc.cu",
                     "fetode_tpu/ops/pallas_node_enc.py:217",
                     enc_launches[1],
                     max(c["g_abs"] for c in enc_checks.values()),
                     et["bwd"], et["plain_bwd"], et["bound_bwd"]),
        kernel_entry("mlp_node_fwd", "fetode_tpu_torch/csrc/mlp_node.cu",
                     "fetode_tpu/ops/pallas_mlp_node.py:280",
                     mlp_launches[0],
                     max(c["fwd_err"] for c in mlp_checks.values()),
                     mt["fwd"], mt["plain_fwd"], mt["bound_fwd"]),
        kernel_entry("mlp_node_bwd", "fetode_tpu_torch/csrc/mlp_node.cu",
                     "fetode_tpu/ops/pallas_mlp_node.py:308",
                     mlp_launches[1],
                     max(c["g_abs"] for c in mlp_checks.values()),
                     mt["bwd"], mt["plain_bwd"], mt["bound_bwd"]),
        kernel_entry("kanfet_wide_fwd", "fetode_tpu_torch/csrc/kanfet_wide.cu",
                     "fetode_tpu/ops/pallas_kanfet_wide.py:632",
                     wide_launches[0],
                     max(c["fwd_err"] for c in wide_checks.values()),
                     wt["fwd"], wt["plain_fwd"], wt["bound_fwd"]),
        kernel_entry("kanfet_wide_bwd", "fetode_tpu_torch/csrc/kanfet_wide.cu",
                     "fetode_tpu/ops/pallas_kanfet_wide.py:663",
                     wide_launches[1],
                     max(c["g_abs"] for c in wide_checks.values()),
                     wt["bwd"], wt["plain_bwd"], wt["bound_bwd"]),
        kernel_entry("ferro_apply_fused", "fetode_tpu_torch/csrc/ferro_fused.cu",
                     "fetode_tpu/ops/pallas_ferro.py:107", ff_launches,
                     ff_err, ff["ms"], ff["plain"], ff["bound"]),
        kernel_entry("spline_matmul_fused", "fetode_tpu_torch/csrc/spline.cu",
                     "fetode_tpu/ops/pallas_spline.py:65",
                     sc_launches["spline"], sc_errs["spline"], st["ms"],
                     st["plain"], st["bound"]),
        kernel_entry("custom_field_fwd", "fetode_tpu_torch/csrc/custom_field.cu",
                     "examples/02_custom_field_kernel.py:95",
                     sc_launches["custom_fwd"], sc_errs["custom_fwd"],
                     ct["fwd"], ct["plain_fwd"], ct["bound_fwd"]),
        kernel_entry("custom_field_bwd", "fetode_tpu_torch/csrc/custom_field.cu",
                     "examples/02_custom_field_kernel.py:116",
                     sc_launches["custom_bwd"], sc_errs["custom_bwd"],
                     ct["bwd"], ct["plain_bwd"], ct["bound_bwd"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
