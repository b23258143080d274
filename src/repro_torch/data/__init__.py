"""The port's data layer (counterpart of `repro.data`): the synthetic token
pipeline, `data.pipeline`."""
