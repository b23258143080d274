"""The port's core: quantizers, the packed wire, and the pipeline API
(counterparts of `repro.core`'s modules of the same names)."""
