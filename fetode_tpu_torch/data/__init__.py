"""Datasets (counterpart of ``fetode_tpu/data/__init__.py``).

Ported so far: ECG200 (``data/ecg200.py``), with its synthetic stand-in
and the shuffled epoch batching it needs.
"""
