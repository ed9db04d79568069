"""Training: the optimiser, the step loop and the workload drivers
(counterpart of ``fetode_tpu/train/__init__.py``).

Adam and AdamW with global-norm clipping and cosine decay
(``optim.py``), the full-batch, minibatch and population step loops
(``loop.py``), durable checkpoint/resume (``checkpoint.py``), the
predprey drivers, single trajectory (``predprey_driver.py``) and a
batched population of initial conditions (``traj_driver.py``), and the
ECG, forecasting and conditional-diffusion trainers
(``ecg_driver.py``, ``forecast_driver.py``,
``cond_diffusion_driver.py``).
"""

from fetode_tpu_torch.train.loop import (  # noqa: F401
    TrainState,
    init_state,
    make_epoch_scanner,
    make_minibatch_epoch,
    make_minibatch_epochs_scanner,
    make_train_step,
)
from fetode_tpu_torch.train.optim import make_optimizer  # noqa: F401
