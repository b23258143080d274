"""The port's checkpoint layer (counterpart of `repro.checkpoint`): the
atomic, async, retention-limited manager, `checkpoint.manager`."""
