"""Dataset loaders, window datasets, scalers, time features, metrics
(counterpart of ``fetode_tpu/data/__init__.py``, with the same exports).

numpy and scipy throughout: the pandas and sklearn steps of the JAX
package are done on the column tables of ``data/columns.py``.
"""

from fetode_tpu_torch.data.ecg200 import (  # noqa: F401
    batch_iterator,
    load_ecg200,
    synthetic_ecg200,
)
from fetode_tpu_torch.data.informer import (  # noqa: F401
    WindowSplit,
    dataset_custom,
    dataset_ett_hour,
    dataset_ett_minute,
    dataset_pred,
)
from fetode_tpu_torch.data.masking import (  # noqa: F401
    apply_mask,
    causal_mask,
    prob_mask,
)
from fetode_tpu_torch.data.metrics import (  # noqa: F401
    corr,
    mae,
    mape,
    metric,
    mse,
    mspe,
    rmse,
    rse,
)
from fetode_tpu_torch.data.multimodal import (  # noqa: F401
    assert_feature_dim,
    embed_text,
    fuse_features,
    merge_with_text,
)
from fetode_tpu_torch.data.paths import locate  # noqa: F401
from fetode_tpu_torch.data.timefeatures import time_features  # noqa: F401
from fetode_tpu_torch.data.timeseries import (  # noqa: F401
    Standardizer,
    load_ett_csv,
    load_timemmd_csv,
    make_windows,
    split_time_series,
    standardize_fit,
    synthetic_series,
    window_batches,
)
