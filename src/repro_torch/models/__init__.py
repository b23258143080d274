"""The port's models layer (counterpart of `repro.models`): the dense and
vlm decoders' decode step over a raw or quantized KV cache (`serve`), the
continuous-batching `engine`, and the `model.build` dispatcher."""
from .model import ModelBundle, build

__all__ = ["ModelBundle", "build"]
