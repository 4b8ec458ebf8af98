"""Host utilities of the torch port: copies of ``merfin_tpu.utils``'s
checkpoint, part-merge and prefetch modules."""
