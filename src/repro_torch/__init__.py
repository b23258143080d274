"""PyTorch/CUDA port of the guaranteed-error-bound quantizer stack.

The JAX package `repro` is the reference; this package imports `torch`
and `numpy` only.  Slice 1 runs the main path
`Pipeline.encode` -> `Encoded` -> `Pipeline.decode` for the chains
`abs|rel|noa:<eb>|pack:{8,16,32}` through four hand-written CUDA kernels
(`kernels/csrc/pack.cu`).  Entry point: `repro_torch.core.pipeline`.
"""
