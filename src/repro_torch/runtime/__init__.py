"""The port's runtime layer (counterpart of `repro.runtime`): the
fault-injection harness of the audit plane, `runtime.guard`, and the
fault-tolerant training loop, `runtime.train_loop`."""
