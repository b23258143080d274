"""Port parity for the slice as a whole: `repro_torch.core.pipeline` against
the JAX package's `repro.core.pipeline` on the chains
`abs|rel|noa:<eb>|pack:{8,16,32}`, bit for bit (no tolerance), plus the
grammar, the registry mirror, wire accounting, cross-decoding through
`interop`, the package's import rules, and the card-by-default entry points.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.registry import PIPELINES as J_PIPELINES
from repro.core import pipeline as JP
from repro_torch.configs.registry import PIPELINES, get_pipeline
from repro_torch.core import audit as TA
from repro_torch.core import interop
from repro_torch.core import pipeline as TP

REPO = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(1104)
PLANES = ("payload", "payload_len", "out_idx", "out_payload", "n_outliers",
          "overflow", "sign_words", "eb")
SPECS = [f"{m}:{eb}|pack:{b}" for m, eb in (("abs", 0.01), ("rel", 0.001),
                                             ("noa", 0.001))
         for b in (8, 16, 32)]


def _field(n):
    """Lognormal NYX-like values with the special-value sweep up front."""
    x = np.exp(RNG.standard_normal(n) * 1.4 + 2.0).astype(np.float32)
    x[::3] *= -1
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
             np.uint32(0x7FC00123).view(np.float32), 5e-4]
    return x


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _assert_encoded(t, j):
    for f in PLANES:
        a, b = getattr(t, f), getattr(j, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b), err_msg=f)
    assert t.headers == () and j.headers == ()


def _assert_bound(x, y, enc, spec):
    """Every value within eb of its original or bit-identical to it —
    asserted only where the table did not overflow and some values are
    not outliers (ROADMAP C-ref-1)."""
    if bool(enc.overflow) or int(enc.n_outliers) >= x.size:
        return
    same = _u32(x) == _u32(y)
    with np.errstate(invalid="ignore"):
        err = np.abs(x.astype(np.float64) - y.astype(np.float64))
    cfg = TP.parse_pipeline(spec).qcfg()
    eb = np.float64(np.float32(cfg.error_bound if enc.eb is None
                               else enc.eb.item()))
    lim = eb * np.abs(x.astype(np.float64)) if cfg.mode == "rel" else eb
    assert np.all(same | (err <= lim))


@pytest.mark.parametrize("n", [4101])
@pytest.mark.parametrize("spec", SPECS)
def test_pipeline_matches_reference(spec, n):
    x = _field(n)
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    assert tp.spec() == jp.spec()
    t = tp.encode(x, device="cpu", kernels=False)
    j = jp.encode(jnp.asarray(x), kernels=False)
    _assert_encoded(t, j)
    assert tp.wire_bits(t, n) == jp.wire_bits(j, n)
    assert tp.wire_bytes(t, n) == jp.wire_bytes(j, n)
    assert tp.capacity_bytes(t) == jp.capacity_bytes(j)
    y = tp.decode(t, n=n, device="cpu", kernels=False).numpy()
    np.testing.assert_array_equal(_u32(y), _u32(jp.decode(j, n=n, kernels=False)))
    # dispatch is bit-transparent: the kernel entry (plain on the CPU) agrees
    tk = tp.encode(x, device="cpu", kernels=True)
    _assert_encoded(tk, j)
    yk = tp.decode(tk, shape=(n,), device="cpu").numpy()
    np.testing.assert_array_equal(_u32(yk), _u32(y))
    _assert_bound(x, y, t, spec)


def test_grad_wire_traced_eb_matches_reference():
    """The grad-wire-8 preset with a per-tensor bound (a 0-d tensor)."""
    spec = get_pipeline("grad-wire-8")
    x = (RNG.standard_normal(6000) * 3e-3).astype(np.float32)
    eb = np.float32(2.0 ** -5 * np.sqrt(np.mean(x.astype(np.float64) ** 2)))
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    t = tp.encode(x, torch.tensor(eb), device="cpu")
    j = jp.encode(jnp.asarray(x), jnp.asarray(eb), kernels=False)
    _assert_encoded(t, j)
    y = tp.decode(t, n=x.size, device="cpu").numpy()
    np.testing.assert_array_equal(_u32(y), _u32(jp.decode(j, n=x.size,
                                                          kernels=False)))
    assert not bool(t.overflow)
    _assert_bound(x, y, t, spec)


@pytest.mark.parametrize("spec", ["abs:0.01|pack:8", "rel:0.001|pack:16",
                                  "noa:0.001|pack:32"])
def test_interop_cross_decodes(spec):
    """A wire encoded by either package decodes bit-identically in the
    other, through `interop`."""
    n = 2500
    x = _field(n)
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    j = jp.encode(jnp.asarray(x), kernels=False)
    y_j = np.asarray(jp.decode(j, n=n, kernels=False))
    from_j = interop.encoded_from_numpy(j, device="cpu")
    _assert_encoded(from_j, j)
    np.testing.assert_array_equal(
        _u32(tp.decode(from_j, n=n, device="cpu").numpy()), _u32(y_j))
    t = tp.encode(x, device="cpu")
    planes = interop.encoded_to_numpy(t)
    assert planes.payload.dtype == np.uint32
    j_wire = JP.Encoded(*[None if f is None else
                          (tuple(map(jnp.asarray, f)) if isinstance(f, tuple)
                           else jnp.asarray(f)) for f in planes])
    np.testing.assert_array_equal(_u32(jp.decode(j_wire, n=n, kernels=False)),
                                  _u32(y_j))


def test_registry_mirror_and_grammar():
    assert PIPELINES == J_PIPELINES
    for name, spec in PIPELINES.items():
        assert get_pipeline(name) == spec
        pipe = TP.parse_pipeline(spec)        # every preset is ported
        assert pipe.spec() == JP.parse_pipeline(spec).spec()
        assert TP.parse_pipeline(pipe.spec()) == pipe
    assert TP.parse_pipeline(get_pipeline("grad-wire-8")).spec() == \
        "abs:1.0:cap=0.015625|pack:8"
    for spec in ("rel:1e-3|pack:16", "noa:0.5|pack:8", "abs:2.5e-05:cap=0.5|pack:32"):
        assert TP.parse_pipeline(spec).spec() == JP.parse_pipeline(spec).spec()
        assert TP.parse_pipeline(TP.parse_pipeline(spec).spec()) == \
            TP.parse_pipeline(spec)
    with pytest.raises(KeyError):
        get_pipeline("no-such-preset")


_SPEC_CASES = [
    # (spec, exception or None, match); None: the chain is ported (A7, A8)
    # and parses to the reference's spec.  The ids are the ones these cases
    # had while the chains raised NotImplementedError.
    ("delta|abs:1e-3|pack:8", None, "A8"),
    ("abs:1e-3|pack:8|zero|ent", None, "A7"),
    ("rel:1e-3|pack:32|narrow|shuffle", None, "A7"),
    ("rel:1e-3|pack:32|shuffle|narrow", None, "A7"),
    ("abs:1e-3|pack:16|ent", None, "A7"),
    ("abs:1e-3:dtype=float64|pack:16", NotImplementedError, "C-port-2"),
    ("abs:1e-3|pack:8|bogus", ValueError, "unknown stage"),
    ("bogus:1e-3|pack:8", ValueError, "unknown stage"),
    ("abs:1e-3|pack:12", ValueError, "pack bits"),
    ("abs:1e-3", ValueError, "at least"),
]


@pytest.mark.parametrize(
    "spec,exc,item", _SPEC_CASES,
    ids=[f"{s}-{'NotImplementedError' if e is None else e.__name__}-{m}"
         for s, e, m in _SPEC_CASES])
def test_unported_and_bad_specs_raise(spec, exc, item):
    """Bad specs raise, float64 still raises (C-port-2), and the chains of
    A7/A8 that raised before this slice now parse like the reference's."""
    if exc is None:
        pipe = TP.parse_pipeline(spec)
        assert pipe.spec() == JP.parse_pipeline(spec).spec()
        assert TP.parse_pipeline(pipe.spec()) == pipe
        return
    with pytest.raises(exc, match=item):
        TP.parse_pipeline(spec)


def test_unported_options_raise():
    """float64 data still raises (C-port-2); verify=, integrity= and
    return_quantized= (A9, A10), which raised before this slice, now return
    the reference's shapes: enc | (enc, qt) | (enc, report) |
    (enc, qt, report)."""
    pipe = TP.parse_pipeline("abs:1e-3|pack:16")
    x = np.zeros(16, np.float32)
    enc = pipe.encode(x, device="cpu")
    assert isinstance(enc, TP.Encoded) and enc.checksum is None
    enc_i = pipe.encode(x, device="cpu", integrity=True)
    assert enc_i.checksum is not None
    enc_v, rep = pipe.encode(x, device="cpu", verify=True)
    assert isinstance(rep, TA.AuditReport) and bool(rep.ok())
    enc_q, qt = pipe.encode(x, device="cpu", return_quantized=True)
    assert qt.bins.shape == (16,)
    enc_qv, qt, rep = pipe.encode(x, device="cpu", verify=True,
                                  return_quantized=True)
    for e in (enc_v, enc_q, enc_qv):
        assert torch.equal(e.payload, enc.payload)
    y = pipe.decode(enc_i, n=16, device="cpu", verify=True)
    assert torch.equal(y, pipe.decode(enc, n=16, device="cpu"))
    with pytest.raises(NotImplementedError, match="C-port-2"):
        pipe.encode(x.astype(np.float64), device="cpu")


def test_entry_points_default_to_the_card():
    """With no CUDA device, encode/decode without device='cpu' raise; they
    never carry on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    pipe = TP.parse_pipeline("rel:1e-3|pack:16")
    x = np.ones(64, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.encode(x)
    enc = pipe.encode(x, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.decode(enc, n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.encoded_from_numpy(enc)


def test_payload_len_guard():
    pipe = TP.parse_pipeline("abs:1e-3|pack:16")
    enc = pipe.encode(np.ones(300, np.float32), device="cpu")
    for bad in (-1, enc.payload.shape[0] + 1):
        corrupt = enc._replace(payload_len=torch.tensor(bad, dtype=torch.int32))
        with pytest.raises(TA.WireIntegrityError, match="payload_len"):
            pipe.decode(corrupt, n=300, device="cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero with no result line when there is no
    CUDA device, and also alone in a directory without the repository."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def _chip_script(name):
    sys.path.insert(0, str(REPO))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO))


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__0_7_pack_cu_0d13unpack_kernelILi8ELb1EEEvPKjxS2_PKfffPfxx' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__0_7_pack_cu_0d13unpack_kernelILi8ELb1EEEvPKjxS2_PKfffPfxx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__0_7_pack_cu_0d11pack_kernelILi32ELb0EEEvPKfxxS2_ffNS_9RelParamsEiPjxPhS4_b' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__0_7_pack_cu_0d11pack_kernelILi32ELb0EEEvPKfxxS2_ffNS_9RelParamsEiPjxPhS4_b
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 16 bytes cumulative stack size
"""


def test_chip_smoke_reads_ptxas_lines_of_pack_kernel():
    """Only pack_kernel's instances, not unpack_kernel's."""
    cs = _chip_script("chip_smoke")
    assert cs.ptxas_summary(PTXAS_LOG) == {"32,abs": {
        "stack": 16, "spill_stores": 12, "spill_loads": 8, "registers": 48}}


SASS = """\
\t\tFunction : _ZN39_GLOBAL__N__0_7_pack_cu_0d11pack_kernelILi8ELb1EEEvPKfxx
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x000 */
        /*0010*/               @P0 EXIT ;                         /* 0x000 */
        /*0020*/              @!P1 BRA 0x90 ;                     /* 0x000 */
        /*0030*/                   LDG.E.128.CONSTANT R8, desc[UR6][R28.64] ;
        /*0040*/                   F2I.TRUNC.NTZ R23, R13 ;
        /*0050*/                   FADD R13, R13, 127 ;
        /*0060*/                   LOP3.LUT R32, R32, 0xff, RZ, 0xc0, !PT ;
        /*0070*/                   STG.E.128 desc[UR6][R30.64+0x200], R24 ;
        /*0080*/                   EXIT ;
        /*0090*/                   LDG.E.CONSTANT R3, desc[UR4][R14.64] ;
        /*00a0*/                   I2FP.F32.S32 R34, R31 ;
        /*00b0*/                   STG.E.U8 desc[UR6][R6.64], R31 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0;
        /*00e0*/                   NOP;
\t\tFunction : _ZN39_GLOBAL__N__0_7_pack_cu_0d13unpack_kernelILi8ELb1EEEvPKj
        /*0000*/                   EXIT ;
"""


def test_chip_sass_counts_the_vector_path_by_class():
    """chip_sass.py counts, in a kernel with 16-byte accesses, the block
    that holds them through the EXIT that ends it, by class."""
    sass = _chip_script("chip_sass")
    fns = sass.functions(SASS)
    assert len(fns) == 2
    body = next(b for f, b in fns.items() if "11pack_kernel" in f)
    path, region = sass.counted_path(body)
    assert region == "vector"
    assert [i[2] for i in path] == ["LDG", "F2I", "FADD", "LOP3", "STG",
                                    "EXIT"]
    counts = sass.classify(path)
    assert {k: counts[k] for k in ("total", "loads", "conversions",
                                   "float32", "integer", "stores",
                                   "other")} == {
        "total": 6, "loads": 1, "conversions": 1, "float32": 1,
        "integer": 1, "stores": 1, "other": 1}
    whole, region = sass.counted_path(body[9:])       # the scalar path
    assert region == "whole"
    assert sass.classify(whole)["total"] == 5           # the NOP is left out
