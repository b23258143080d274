"""The port's runtime layer (counterpart of `repro.runtime`): so far the
fault-injection harness of the audit plane, `runtime.guard`."""
