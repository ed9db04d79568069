"""Helpers (counterpart of ``fetode_tpu/utils/__init__.py``)."""
