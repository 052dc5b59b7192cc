"""The benchmark of the PyTorch/CUDA port ``bssm_tpu_torch``: see
``run.py``."""
