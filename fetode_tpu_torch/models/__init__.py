"""Workload models (counterpart of ``fetode_tpu/models/__init__.py``).

Ported so far: the predator-prey KANFET NODE (``models/predprey.py``).
"""
