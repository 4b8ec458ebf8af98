"""Host utilities of the torch port: copies of ``merfin_tpu.utils``'s
checkpoint and prefetch modules."""
