"""The port's compression layer (counterpart of `repro.compression`): so
far the dense half of the KV-cache quantizer, `compression.kv`."""
