"""The score layer of the torch port (counterpart of ``merfin_tpu.score``).

``kstar`` is a copy of the JAX package's host math; ``value_map``,
``bin_table`` and ``kover`` hold the host tables (``ValueMap``,
``BinTable``, ``finish_kover``, copies of the JAX package's) beside
their device lookups.
"""
