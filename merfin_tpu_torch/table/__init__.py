"""Host exact lookup of the torch port (the host half of
``merfin_tpu.table.lookup``)."""
