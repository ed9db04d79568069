"""MNIST loading (raw idx files) and the synthetic digits that stand in
for it (counterpart of ``fetode_tpu/data/mnist.py``).

The loader reads ``train-images-idx3-ubyte``-style files, raw or ``.gz``,
from ``root`` or the data roots of ``data/paths.py`` (``$FETODE_DATA_DIR``
first); without them callers use ``synthetic_digits``.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from fetode_tpu_torch.data.paths import locate


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(split: str = "train", root: str | None = None):
    """Returns (images (N, 28, 28) float32 in [0, 1], labels (N,) int32),
    or raises FileNotFoundError when no MNIST files exist locally."""
    prefix = "train" if split == "train" else "t10k"
    names = [f"MNIST/raw/{prefix}-images-idx3-ubyte",
             f"{prefix}-images-idx3-ubyte"]
    img_path = lbl_path = None
    for n in names:
        candidates = []
        if root:
            candidates += [os.path.join(root, n),
                           os.path.join(root, n + ".gz")]
        candidates += [locate(n), locate(n + ".gz")]
        p = next((c for c in candidates if c and os.path.exists(c)), None)
        if p:
            img_path = p
            lbl_path = p.replace("images-idx3", "labels-idx1")
            break
    if img_path is None or not os.path.exists(lbl_path):
        raise FileNotFoundError("MNIST idx files not found; use "
                                "synthetic_digits for tests")
    images = _read_idx(img_path).astype(np.float32) / 255.0
    labels = _read_idx(lbl_path).astype(np.int32)
    return images, labels


def synthetic_digits(seed: int = 0, n: int = 256, H: int = 28, W: int = 28,
                     n_classes: int = 10):
    """Deterministic digit-like blobs: class k = a bright bar at angle
    k*pi/n_classes through the centre, plus noise.  Linearly separable
    enough to verify a classifier learns."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % n_classes).astype(np.int32)
    rng.shuffle(y)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cy, cx = (H - 1) / 2, (W - 1) / 2
    imgs = np.zeros((n, H, W), np.float32)
    for k in range(n_classes):
        ang = k * np.pi / n_classes
        d = np.abs(-(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang))
        bar = np.exp(-(d ** 2) / 4.0)
        imgs[y == k] = bar
    imgs += rng.normal(0, 0.05, imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 1), y
