"""Neural building blocks (counterpart of ``fetode_tpu/nn/__init__.py``)."""
