"""The benchmark of merfin_tpu_torch on one NVIDIA H100 (``run.py``).

It measures the port only: nothing here imports JAX or the JAX package,
and the reference (``reference/``) imports nothing of the port either.
"""
