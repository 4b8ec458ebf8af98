"""Report-mode drivers of the torch port (counterpart of
``merfin_tpu.modes``)."""
