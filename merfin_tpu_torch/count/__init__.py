"""k-mer counting and MKDB set algebra of the torch port: the counter
(``counter.py``, device accumulation in PyTorch), its out-of-core spill
(``spill.py``) and the meryl-analog algebra (``algebra.py``)."""
