"""Host input/output of the torch port: copies of ``merfin_tpu.io``'s
FASTA, MKDB, -prob, VCF and compressed-file modules."""
