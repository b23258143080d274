"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here carries the `cuda` marker and skips without an NVIDIA card
(CUDA kernels have no CPU mode).  The file imports nothing of JAX, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports JAX).  `chip_smoke.py`
runs the same checks at the main path's full size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import pack as TK

RNG = np.random.default_rng(1106)


def _mix(n):
    """Normal values, the special-value sweep, and exact half-way ties
    (ABS at eb2 = 2**-6, REL at log_step = 2**-10), where rintf's
    round-half-to-even must agree with torch.round."""
    x = (RNG.standard_normal(n) * 10).astype(np.float32)
    k = np.arange(min(n, 4096) // 2)
    ties = np.concatenate([(k - k.size / 2 + 0.5) * 2.0 ** -6,
                           np.ldexp(1.0 + (k % 1000 + 0.5) * 2.0 ** -10,
                                    k % 40 - 20)])
    x[8:8 + ties.size] = ties[:max(0, n - 8)]
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
             np.uint32(0x7FC00123).view(np.float32), 5e-4][:n]
    return x


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4095, 4096 * 3 + 129])
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_kernels_match_plain_versions_on_card(mode, bits, n):
    _need_card()
    cfg = TCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    x = torch.from_numpy(_mix(max(n, 8))[:n]).cuda()
    before = dict(TK.LAUNCHES)
    if mode == "rel":
        k_out = TK.rel_pack(x, cfg)
        p_out = TK._rel_pack_plain(x, cfg)
    else:
        eb = torch.tensor([7.5e-3], device="cuda")
        k_out = TK.abs_pack(x, eb, cfg)
        p_out = TK._abs_pack_plain(x, eb, cfg)
    for a, b in zip(k_out, p_out):
        assert torch.equal(a, b)
    if mode == "rel":
        y = TK.rel_unpack(k_out[0], k_out[2], n, cfg)
        want = TK._rel_unpack_plain(k_out[0], k_out[2], n, cfg)
    else:
        y = TK.abs_unpack(k_out[0], eb, n, cfg)
        want = TK._abs_unpack_plain(k_out[0], eb, n, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    name = "_rel" if mode == "rel" else "_abs"
    assert TK.LAUNCHES[name + "_pack"] == before[name + "_pack"] + 1
    assert TK.LAUNCHES[name + "_unpack"] == before[name + "_unpack"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["abs:0.01|pack:8", "rel:0.001|pack:16",
                                  "noa:0.001|pack:32"])
def test_pipeline_on_card_matches_cpu(spec):
    """The card's kernel path against the CPU reference, plane by plane."""
    _need_card()
    from repro_torch.core.pipeline import parse_pipeline
    pipe = parse_pipeline(spec)
    x = _mix(9000)
    on_card = pipe.encode(x)
    on_cpu = pipe.encode(x, device="cpu")
    for a, b in zip(on_card, on_cpu):
        if torch.is_tensor(a):
            assert torch.equal(a.cpu(), b)
    y = pipe.decode(on_card, n=x.size).cpu()
    assert torch.equal(y.view(torch.int32),
                       pipe.decode(on_cpu, n=x.size, device="cpu").view(torch.int32))
