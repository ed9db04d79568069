"""Runnable examples of the port (counterparts of the repo's
``examples/``), run as ``python -m fetode_tpu_torch.examples.<name>``.
Importing one compiles and launches nothing.
"""
