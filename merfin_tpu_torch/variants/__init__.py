"""Variant-path enumeration and scoring of the torch port (counterpart of
``merfin_tpu.variants``).

``enumerate``, ``enumerate_fast``, ``score`` (the host scorer) and
``select`` are copies of the JAX package's host modules;
``device_score`` is the port of its fused device scorer.
"""
