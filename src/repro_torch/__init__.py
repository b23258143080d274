"""PyTorch/CUDA port of the guaranteed-error-bound quantizer stack.

The JAX package `repro` is the reference; this package imports `torch`
and `numpy` only.  Entry points: `repro_torch.core.pipeline` (the main
path `Pipeline.encode` -> `Encoded` -> `Pipeline.decode` for every chain
of the grammar: `delta`/`lorenzo`/`kvdelta` predictors, the
`abs|rel|noa:<eb>|pack:{8,16,32}` quantizers and the `zero`/`narrow`/
`shuffle`/`ent` word stages, with the audit plane's `verify=` reports and
checksums, `core.audit`, and its fault harness `runtime.guard`),
`repro_torch.kernels.ops` (the dense-layout quantize/dequantize),
`repro_torch.compression.kv` with `repro_torch.kernels.kv_attention` (the
int8 quantized KV cache, its packed wire and its flash-decode attention),
`repro_torch.compression.grads` (the compressed gradient all-reduce over
`core.transport`), and `repro_torch.models` (the dense, vlm and MoE
families' decode step over a raw or quantized cache, their forward pass
and prefill, the `DecodeEngine` and `stream_prefill`).  Every
kernel is hand-written CUDA C++ in `kernels/csrc/`.
"""
