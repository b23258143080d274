"""PyTorch/CUDA port of the guaranteed-error-bound quantizer stack.

The JAX package `repro` is the reference; this package imports `torch`
and `numpy` only.  Entry points: `repro_torch.core.pipeline` (the main
path `Pipeline.encode` -> `Encoded` -> `Pipeline.decode` for the chains
`abs|rel|noa:<eb>|pack:{8,16,32}` and their `zero`/`narrow` chunk stages),
`repro_torch.kernels.ops` (the dense-layout quantize/dequantize),
`repro_torch.compression.kv` with `repro_torch.kernels.kv_attention` (the
int8 quantized KV cache and its flash-decode attention).  Every kernel is
hand-written CUDA C++ in `kernels/csrc/`.
"""
