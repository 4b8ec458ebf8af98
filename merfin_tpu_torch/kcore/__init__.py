"""Host 2-bit k-mer packing of the torch port (a copy of
``merfin_tpu.kcore.pack``)."""
