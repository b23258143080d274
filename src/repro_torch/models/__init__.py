"""The port's models layer (counterpart of `repro.models`): the dense, vlm
and MoE decoders (`transformer`, `moe`), their decode step over a raw or
quantized KV cache (`serve`), the continuous-batching `engine` with
`stream_prefill`, and the `model.build` dispatcher (`prefill`)."""
from .model import ModelBundle, build

__all__ = ["ModelBundle", "build"]
