"""merfin_tpu_torch — the PyTorch/CUDA port of merfin_tpu.

A second package beside the JAX one, held to it byte for byte: the same
CLI flags, output files and stderr lines.  Plain tensor code is PyTorch;
the union sorted join that carries -hist is a hand-written CUDA kernel
(``csrc/union_join.cu``) with a plain PyTorch version beside it.

Framework-free host code (MKDB/FASTA/prob-table I/O, the 2-bit packers,
the exact host tables of ``merfin_tpu.score``, checkpointing) is shared
with ``merfin_tpu``; nothing here imports JAX.
"""

__version__ = "0.1.0"
