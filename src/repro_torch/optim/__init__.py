"""The port's optimizer (counterpart of `repro.optim`): AdamW with float32
master copies, `optim.optimizer`."""
