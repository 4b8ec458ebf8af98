"""Device tails of the score layer (counterpart of ``merfin_tpu.score``).

The exact host tables (``ValueMap``, ``BinTable``, ``finish_kover``) are
shared with the JAX package; these modules port only the device lookups.
"""
