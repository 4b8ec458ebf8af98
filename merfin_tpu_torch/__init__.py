"""merfin_tpu_torch — the PyTorch/CUDA port of merfin_tpu.

A second package beside the JAX one, held to it byte for byte: the same
CLI flags, output files and stderr lines.  Plain tensor code is PyTorch;
the sorted joins are hand-written CUDA kernels (``csrc/``) with plain
PyTorch versions beside them.

The port shares no code with ``merfin_tpu``: it keeps its own copies of
the host modules it needs (MKDB/FASTA/prob-table/VCF/meryl-text I/O, the
2-bit packers, the exact host tables of the score layer, the variant
enumeration, host scorer and selectors, checkpointing, the counter's
host merges and disk spill, the MKDB set algebra, the GenomeScope
lookup-table tool, and the native
host library ``csrc/fastio.cpp``, built with g++ into
``build/merfin_tpu_torch/``).  Nothing here imports JAX or merfin_tpu.
"""

__version__ = "0.1.0"
