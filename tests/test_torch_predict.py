"""Port parity of the value-domain predictors: `repro_torch.core.predict`
against `repro.core.predict` and its literal reconstruction-feedback loop
(`scan_reference`), bit for bit, at shapes of one to four dims and pack
widths 8/16/32, including streams whose differences and running sums wrap;
and the three pred presets through `repro_torch.core.pipeline` with
`pred_shape` against `repro.core.pipeline`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import predict as JPR
from repro_torch.configs.registry import get_pipeline
from repro_torch.core import pipeline as TP
from repro_torch.core import predict as TPR

from test_torch_stages import ENT_CHUNKS, check_chain

RNG = np.random.default_rng(1608)
STAGES = {"delta": (TPR.DeltaStage(), JPR.DeltaStage()),
          "lorenzo": (TPR.LorenzoStage(), JPR.LorenzoStage()),
          "kvdelta": (TPR.KVDeltaStage(), JPR.KVDeltaStage())}
SHAPES = [(37,), (5, 7), (3, 4, 6), (2, 2, 3, 5)]


def _bins(shape, bits, wrap=False):
    """int32 bins inside (-maxbin, maxbin); with `wrap`, runs of values at
    +-(maxbin - 1), so the residuals leave the `bits`-bit range and (at
    bits = 32) the decoder's running sums leave int32's."""
    maxbin = (1 << (bits - 1)) - 1
    n = int(np.prod(shape))
    if wrap:
        b = np.where(RNG.random(n) < 0.5, maxbin - 1, 1 - maxbin)
        b[::5] = RNG.integers(1 - maxbin, maxbin, b[::5].size)
    else:
        b = RNG.integers(-50, 50, n)
    return b.astype(np.int32)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(STAGES))
def test_predictor_matches_reference_and_scan(name, shape, bits, wrap):
    ts, js = STAGES[name]
    bins = _bins(shape, bits, wrap)
    codes = ts.encode_bins(torch.from_numpy(bins), shape, bits)
    j_codes = np.asarray(js.encode_bins(jnp.asarray(bins), shape, bits))
    np.testing.assert_array_equal(codes.numpy(), j_codes)
    scan_codes, scan_recon = TPR.scan_reference(ts, bins, shape, bits)
    np.testing.assert_array_equal(codes.numpy(), scan_codes)
    np.testing.assert_array_equal(scan_recon, bins)
    j_scan = JPR.scan_reference(js, bins, shape, bits)
    np.testing.assert_array_equal(scan_codes, j_scan[0])
    back = ts.decode_bins(codes, shape, bits)
    np.testing.assert_array_equal(back.numpy(), bins)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(js.decode_bins(jnp.asarray(j_codes), shape,
                                                bits)))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_bit_helpers_match_reference(bits):
    """_sign_extend, _fold and _unfold on every int32 corner."""
    v = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 127, -128, 255, 32767,
                  -32768, 65535, 2 ** 30, -2 ** 30], np.int64)
    v = np.concatenate([v, RNG.integers(-2 ** 31, 2 ** 31, 64)]).astype(np.int32)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(TPR._sign_extend(t, bits).numpy(),
                                  np.asarray(JPR._sign_extend(jnp.asarray(v),
                                                              bits)))
    folded = TPR._fold(t, bits)
    np.testing.assert_array_equal(folded.numpy(),
                                  np.asarray(JPR._fold(jnp.asarray(v), bits)))
    np.testing.assert_array_equal(
        TPR._unfold(folded, bits).to(torch.int32).numpy(),
        np.asarray(JPR._unfold(jnp.asarray(folded.numpy()), bits)))


def test_pred_registry_and_chain_ops():
    assert sorted(TPR.PRED_STAGES) == sorted(JPR.PRED_STAGES)
    chain = TPR.parse_pred_stages("delta|kvdelta")
    assert [s.spec() for s in chain] == ["delta", "kvdelta"]
    assert TPR.parse_pred_stages(chain) is chain
    assert TPR.parse_pred_stages("none") == ()
    with pytest.raises(ValueError, match="unknown pred stage"):
        TPR.parse_pred_stages("bogus")
    with pytest.raises(ValueError, match="takes no parameters"):
        TPR.parse_pred_stages("delta:3")
    shape, bits = (4, 6, 5), 16
    bins = _bins(shape, bits)
    codes = TPR.encode_pred_stages(chain, torch.from_numpy(bins), shape, bits)
    j_codes = JPR.encode_pred_stages(JPR.parse_pred_stages("delta|kvdelta"),
                                     jnp.asarray(bins), shape, bits)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(
        TPR.decode_pred_stages(chain, codes, shape, bits).numpy(), bins)
    TPR.register_pred_stage("delta2", lambda name, tokens: TPR.DeltaStage())
    try:
        pipe = TP.parse_pipeline("delta2|abs:0.01|pack:16")
        assert pipe.pred == (TPR.DeltaStage(),)
    finally:
        del TPR.PRED_STAGES["delta2"]


# ------------------------------------------------------- pred presets ---

@pytest.mark.parametrize("name,n,pred_shape", [
    ("grad-wire-pred", ENT_CHUNKS * 1024, None),
    ("sci-lorenzo-ent", ENT_CHUNKS * 512, (ENT_CHUNKS * 4, 128)),
    ("kv-delta", ENT_CHUNKS * 32 * 64, (ENT_CHUNKS, 32, 64)),
])
def test_pred_presets_match_reference(name, n, pred_shape):
    """Each pred preset with its pred_shape (lorenzo: 2-D planes; kvdelta:
    pages of 32 tokens by 64 channels): every plane, wire_bits,
    stage_report and the decoded floats equal the reference's; the kernel
    entry (the dense kernels' plain versions on the CPU) gives the same.
    The `ent` inputs are ENT_CHUNKS chunks long, as in test_torch_stages."""
    pipe, _ = check_chain(get_pipeline(name), n, pred_shape=pred_shape)
    assert pipe.kernel_dispatch() == "repro_torch.kernels.dense.encode_packed"


def test_pred_shape_mismatch_raises():
    pipe = TP.parse_pipeline("lorenzo|abs:0.01|pack:16")
    with pytest.raises(ValueError, match="pred_shape"):
        pipe.encode(np.zeros(100, np.float32), device="cpu",
                    pred_shape=(9, 9))
