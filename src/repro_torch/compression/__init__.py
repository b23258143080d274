"""The port's compression layer (counterpart of `repro.compression`): the
KV-cache quantizer and its packed wire (`compression.kv`) and the
compressed gradient all-reduce (`compression.grads`)."""
