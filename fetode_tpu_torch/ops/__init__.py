"""Basis-function primitives and hand-written kernels (counterpart of
``fetode_tpu/ops/__init__.py``).

Modules are imported by path (``fetode_tpu_torch.ops.ferro`` ...); the
CUDA kernels build on first use, never at import.
"""
