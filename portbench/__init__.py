"""The benchmark of fdapde_core_tpu_torch; see ``run.py``."""
