"""Variant-path scoring of the torch port (counterpart of
``merfin_tpu.variants``).

Enumeration, the host scorer's f64 math and the selectors are shared
host code of ``merfin_tpu.variants``; only the fused device scorer is
ported here.
"""
