"""Device ops of the torch port (counterpart of ``merfin_tpu.ops``)."""
