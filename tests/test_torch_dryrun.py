"""The port's dry-run (`repro_torch.launch.dryrun`, `launch.cost`,
`core.axis.MetaAxis`) against the JAX package's (`repro.launch.dryrun`,
`hlo_analysis`), on the CPU:

  (a) every param, batch and cache leaf's spec and per-rank block on all
      cells of both production meshes equal to the reference's
      `param_shardings`, `_batch_shardings` and `_greedy_sharding` (a
      subprocess with 512 forced host devices, compiling nothing);
  (b) FLOPs counted on meta against `hlo_analysis.dot_flops` of the
      reference's jitted steps on one CPU device (the hybrid's forward
      with its scans scaled: tests/test_torch_scan_count.py);
  (c) what MetaAxis returns and records against what ThreadAxis moves;
  (d) the peak tracker against a hand count;
  (e) whole cells at full width on meta (whisper-base, olmoe-1b-7b at
      decode_32k, both meshes);
  (f) the data-axis train step on a 2 x 2 thread mesh against one rank;
  (g) each kernel wrapper's meta path.

torch runs on one thread here (`test_torch_moe.one_thread`).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import SHAPES
from repro_torch.core.axis import MetaAxis, run_threads
from repro_torch.launch import cost, dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import train as TT
from repro_torch.models import build
from repro_torch.optim import optimizer as opt

from test_torch_moe import one_thread  # noqa: F401  (autouse fixture)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import reference_jobs as RJ  # noqa: E402


def _job(job: str, out: Path, devices: int):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen([sys.executable, str(HERE / "reference_jobs.py"),
                             job, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module", autouse=True)
def reference_dryrun_jobs(tmp_path_factory):
    """The reference's layouts (512 forced host devices) and step FLOPs
    (one device), each in a process of its own, started with the module:
    {job: (process, json path)}."""
    d = tmp_path_factory.mktemp("reference_dryrun")
    jobs = {name: (_job(name, d / f"{name}.json", n), d / f"{name}.json")
            for name, n in (("layouts", 512), ("flops", 1))}
    yield jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _reference(jobs, name: str) -> dict:
    proc, path = jobs[name]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err.decode()[-3000:]
    return json.loads(path.read_text())


# ------------------------------------------------------------ (a) layouts --

def _norm(entry):
    return tuple(entry) if isinstance(entry, (list, tuple)) else entry


def _port_leaves(tree, shardings) -> list:
    return [[tuple(s.spec), M.block_shape(t.shape, s)]
            for t, s in zip(T.leaves(tree), T.leaves(shardings))]


def _ref_leaves(leaves) -> list:
    return [[tuple(_norm(e) for e in spec), tuple(shape)]
            for spec, shape in leaves]


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_layouts_equal_the_reference_on_every_cell(reference_dryrun_jobs,
                                                   kind):
    ref = _reference(reference_dryrun_jobs, "layouts")[kind]
    desc = M.make_production_mesh(multi_pod=kind == "multi")
    for arch in sorted(TR.ARCHS):
        bundle = build(TR.get(arch))
        ab = bundle.abstract_params()
        ours = _port_leaves(ab, M.param_shardings(desc, bundle.axes(), ab))
        assert ours == _ref_leaves(ref["params"][arch]), arch
    assert sorted(ref["cells"]) == sorted(f"{a} {s}"
                                          for a, s in DR.all_cells())
    for arch, shape_name in DR.all_cells():
        bundle = build(TR.get(arch))
        shape = SHAPES[shape_name]
        want = ref["cells"][f"{arch} {shape_name}"]
        if shape.kind in ("train", "prefill"):
            batch = bundle.input_specs(shape)
            got = {"batch": _port_leaves(batch, DR.batch_layouts(desc,
                                                                 batch))}
        else:
            got = {}
            for key, q in (("cache", False), ("cache_kvq", True)):
                ins = bundle.input_specs(shape, quantized_kv=q)
                got[key] = _port_leaves(ins["cache"], M.cache_layouts(
                    desc, ins["cache"], shape.global_batch))
            got["batch"] = _port_leaves([ins["tokens"]], [
                M.greedy_sharding(desc, ins["tokens"].shape)])
        assert got == {k: _ref_leaves(v) for k, v in want.items()}, (
            arch, shape_name)


def test_all_cells_and_microbatches_mirror_the_reference(
        reference_dryrun_jobs):
    ref = _reference(reference_dryrun_jobs, "layouts")
    assert [list(c) for c in DR.all_cells()] == ref["all_cells"]
    assert len(DR.all_cells()) == 32
    assert DR.MICROBATCHES == ref["microbatches"]


# -------------------------------------------------------------- (b) FLOPs --

def _port_train_flops(program: str) -> int:
    name, b, s = RJ.FLOPS_TRAIN
    bundle = build(TR.get(name).reduced())
    params = bundle.abstract_params()
    ocfg = opt.AdamWConfig(total_steps=1000)
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    batch = {"tokens": tok, "labels": tok}
    if program == "step":
        step = TT.make_train_step(bundle, None, ocfg)
        ostate = opt.init(params, ocfg)
        with cost.counting() as c:
            step((params, ostate), batch)
        return c.flops
    flat, tdef = T.flatten(params)
    xs = [p.detach().requires_grad_(program == "no_remat") for p in flat]
    with cost.counting() as c:
        loss, _ = bundle.loss(T.unflatten(tdef, xs), batch, remat=False)
        if program == "no_remat":
            torch.autograd.grad(loss, xs, allow_unused=True,
                                materialize_grads=True)
    return c.flops


def test_flops_against_the_reference_hlo(reference_dryrun_jobs):
    """The decode step's FLOPs and the train loss's forward are the
    reference's exactly; its forward and backward without remat within
    2 % (measured 1.6 % below: XLA forms the tied embedding's gradient
    with one more dot).  The dry-run's train step (loss, gradient over
    rematerialized layers, AdamW) counts 0.80 of the reference's: torch's
    checkpoint recomputes each layer's forward once, the reference's HLO
    2.2 times that; it is held between the step without remat and the
    reference's."""
    ref = _reference(reference_dryrun_jobs, "flops")
    name, b, s = RJ.FLOPS_DECODE
    bundle = build(TR.get(name).reduced())
    cache = bundle.make_cache(b, s, device="meta")
    tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
    with cost.counting() as c:
        bundle.serve_step(bundle.abstract_params(), cache, tok, s - 1)
    assert c.flops == ref["decode"]
    assert _port_train_flops("forward") == ref["forward"]
    no_remat = _port_train_flops("no_remat")
    assert abs(no_remat - ref["no_remat"]) <= 0.02 * ref["no_remat"]
    step = _port_train_flops("step")
    assert no_remat < step < ref["train"]


def test_hybrid_forward_flops_against_the_reference_hlo(
        reference_dryrun_jobs, monkeypatch):
    """The reduced jamba's loss forward at FLOPS_HYBRID (T 256: four
    chunks a Mamba block), counted on meta with its scans scaled (chunks
    0 and 1 of the first block run and are measured, every other chunk of
    the seven blocks stands in), is the reference's HLO count exactly:
    `hlo_analysis.computation_multipliers` scales each scan body by its
    trip count, the stand-ins credit the measured chunk."""
    from repro_torch.models import layers as L
    ref = _reference(reference_dryrun_jobs, "flops")
    stood = []
    real = L._stand_in
    monkeypatch.setattr(L, "_stand_in", lambda *a, **k: stood.append(1)
                        or real(*a, **k))
    name, b, s = RJ.FLOPS_HYBRID
    bundle = build(TR.get(name).reduced())
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    with cost.counting() as c:
        bundle.loss(bundle.abstract_params(), {"tokens": tok,
                                               "labels": tok}, remat=False)
    assert len(stood) == 2 + 4 * 6
    assert c.flops == ref["hybrid_forward"]


# ------------------------------------------------------- (c) collectives --

COLLECTIVES = [
    ("psum", lambda ax, t: ax.psum(t), "all-reduce", lambda t, p: t.nbytes),
    ("pmean", lambda ax, t: ax.pmean(t), "all-reduce", lambda t, p: t.nbytes),
    ("pmax", lambda ax, t: ax.pmax(t), "all-reduce", lambda t, p: t.nbytes),
    ("all_gather", lambda ax, t: ax.all_gather(t), "all-gather",
     lambda t, p: p * t.nbytes),
    ("all_to_all", lambda ax, t: ax.all_to_all(t, 0, 1), "all-to-all",
     lambda t, p: t.nbytes),
    ("ppermute", lambda ax, t: ax.ppermute(t, [(i, (i + 1) % 4)
                                              for i in range(4)]),
     "collective-permute", lambda t, p: t.nbytes),
]


@pytest.mark.parametrize("name,fn,kind,nbytes", COLLECTIVES,
                         ids=[c[0] for c in COLLECTIVES])
def test_meta_axis_records_what_thread_axis_moves(name, fn, kind, nbytes):
    p = 4
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    real = run_threads(p, lambda ax: fn(ax, t + ax.rank))
    rec = cost.Recorder()
    out = fn(MetaAxis(p, rec), t.to("meta"))
    assert out.device.type == "meta"
    assert out.shape == real[0].shape and out.dtype == real[0].dtype
    assert rec.bytes == {kind: nbytes(t, p)}


def test_meta_axis_records_the_transposed_collective_in_backward():
    rec = cost.Recorder()
    ax = MetaAxis(4, rec)
    x = torch.empty((8, 6), device="meta", requires_grad=True)
    y = ax.all_to_all(x, 0, 1)
    z = ax.psum(y)
    w = ax.pmean(z)
    torch.autograd.grad(w.sum(), x)
    nb = x.nelement() * 4
    # forward: all-to-all + psum + pmean; backward: psum's psum and the
    # inverse all-to-all (pmean's gradient is its own input's)
    assert rec.bytes == {"all-to-all": 2 * nb, "all-reduce": 3 * nb}
    assert MetaAxis(1, rec).psum(x).shape == x.shape    # size 1 records 0
    assert rec.bytes["all-reduce"] == 3 * nb


# ------------------------------------------------------------ (d) peak --

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_tracker_against_a_hand_count(device):
    g = cost.ALLOC_GRANULE
    base = torch.empty(100, device=device)            # an input: base
    with cost.counting(base=4096) as c:
        a = torch.empty(1000, device=device)          # 4000 -> 4096
        b = a * 2                                     # +4096 = 8192
        v = b.view(10, 100)                           # a view: +0
        del b
        d = a + base[0]                               # b lives in v: 12288
        del v
        e = a + 2                                     # b freed: 12288
        del d, e
        small = torch.empty(3, device=device)         # one granule: 4096+g
        f = torch.empty(3000, device=device)          # 12000: 16096 + g
        f.add_(1)                                     # in place: +0
        del f
    assert c.peak_bytes == 4096 + 12288 + 4096 + g
    assert c.live_bytes == 4096 + 4096 + g            # a and small
    assert small.numel() == 3 and base.numel() == 100
    assert cost.granule_bytes(1) == g and cost.granule_bytes(g + 1) == 2 * g


# ------------------------------------------------------ (e) whole cells --

@pytest.mark.parametrize("arch", ["whisper-base", "olmoe-1b-7b"])
def test_whole_decode_cells_run_on_meta(tmp_path, arch):
    for mesh in ("single", "multi"):
        rec = DR.run_cell(arch, "decode_32k", mesh, results_dir=tmp_path,
                          force=True, hbm_bytes=80 * 2 ** 30)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_devices"] == (256 if mesh == "single" else 512)
        if arch == "olmoe-1b-7b":
            # the MoE family decodes on the reference's layout: the rank
            # holds its blocks of the params and of the cache
            for k in ("params", "cache"):
                assert rec["held_by"][k] == rec["layout_by"][k]
            assert rec["peak_bytes"] >= rec["held_bytes"]
        else:
            assert (rec["peak_bytes"] >= rec["held_bytes"]
                    > rec["layout_bytes"])
        assert rec["flops"] > 0 and rec["launches"] == {}
        assert (tmp_path / f"{mesh}.{arch}.decode_32k.json").exists()
    if arch == "olmoe-1b-7b":
        # the quantized decode: B12 once a layer, the experts' psum
        rec = DR.run_cell(arch, "decode_32k", "single", "kvq",
                          results_dir=tmp_path, force=True)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["launches"] == {"B12": TR.get(arch).n_layers}
        assert rec["collective_bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("arch,shape,mesh,variant", [
    ("xlstm-350m", "decode_32k", "multi", "baseline"),
    ("jamba-1.5-large-398b", "decode_32k", "single", "baseline")])
def test_cells_off_the_layout_run_on_meta(tmp_path, arch, shape, mesh,
                                          variant):
    """A cell whose rank holds whole weights (the ssm family) or whole
    but the experts' block over "model" (every hybrid cell) runs on a
    production mesh whose axes split them under param_shardings: held
    params above the layout's, FLOPs counted."""
    rec = DR.run_cell(arch, shape, mesh, variant, results_dir=tmp_path,
                      force=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["held_by"]["params"] > rec["layout_by"]["params"]
    assert rec["flops"] > 0


def test_whole_train_cell_runs_on_the_layout(tmp_path):
    """The MoE family's compressed train cell (the cheapest train cell on
    meta) on the reference's gradcomp layout: the rank holds its blocks
    of the params under param_shardings with "pod" dropped, its blocks of
    AdamW's state and its pod's row of the residuals, exactly the
    layout's bytes (the batch's tokens stay whole over "model", as a
    prefill's do); the FSDP gather's backward is a reduce-scatter, B8 and
    B2 launch."""
    rec = DR.run_cell("olmoe-1b-7b", "train_4k", "multi", "gradcomp",
                      results_dir=tmp_path, force=True)
    assert rec["status"] == "ok", rec.get("traceback")
    for k in ("params", "opt", "resid"):
        assert rec["held_by"][k] == rec["layout_by"][k], k
    assert rec["collective_bytes"]["reduce-scatter"] > 0
    assert set(rec["launches"]) == {"B8", "B2"}
    assert rec["peak_bytes"] >= rec["held_bytes"] and rec["flops"] > 0


def test_a_stopped_cell_is_recorded_with_its_site(tmp_path, monkeypatch):
    from repro_torch.models import serve
    real = serve.serve_step

    def item_step(cfg, params, cache, tokens, pos, *a, **kw):
        tokens.sum().item()                           # a host sync on meta
        return real(cfg, params, cache, tokens, pos, *a, **kw)

    monkeypatch.setattr(serve, "serve_step", item_step)
    rec = DR.run_cell("olmoe-1b-7b", "decode_32k", "single",
                      results_dir=tmp_path, force=True)
    assert rec["status"] == "error" and rec["op"] == "Tensor.item"
    assert rec["where"].startswith("repro_torch/models/model.py")
    assert DR.main(["--arch", "olmoe-1b-7b", "--shape", "decode_32k",
                    "--mesh", "single", "--results-dir",
                    str(tmp_path)]) == 1


def test_list_prints_the_reference_cells(capsys):
    assert DR.main(["--list"]) == 0
    lines = capsys.readouterr().out.split("\n")
    assert [tuple(ln.split()) for ln in lines if ln] == DR.all_cells()


# ------------------------------------------------ (f) data-parallel step --

def _batch(vocab, b=4, s=16, seed=3):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    tok = torch.from_numpy(tok.astype(np.int32))
    return {"tokens": tok[:, :-1].contiguous(),
            "labels": tok[:, 1:].contiguous()}


def _close(a, b, rel):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        x, y = x.float(), y.float()
        assert torch.allclose(x, y, rtol=0,
                              atol=rel * max(y.abs().max().item(), 1e-30))


def test_data_axis_step_on_a_thread_mesh_matches_one_rank():
    """The reduced olmoe on a 2 x 2 ("data", "model") mesh of thread
    ranks (experts over "model", each data block's rows on its ranks):
    the loss is the mean of the blocks' losses and the gradient the mean
    of their gradients, against one rank per block (the MoE capacity is a
    block's, as the reference's per-shard routing).  Tolerance: the loss
    within 1e-6, each gradient leaf within 2^-7 of its largest value (the
    bfloat16 gradients' rounding: the mesh accumulates the two blocks in
    one backward, the reference here sums two)."""
    cfg = TR.get("olmoe-1b-7b").reduced()
    bundle = build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg.vocab)
    (loss, _), grads = TT.value_and_grad(
        bundle, params, batch, M.Mesh((2, 2), ("data", "model")))
    halves = [TT.value_and_grad(bundle, params,
                                {k: v[i * 2:(i + 1) * 2]
                                 for k, v in batch.items()})
              for i in range(2)]
    want_loss = (halves[0][0][0] + halves[1][0][0]) / 2
    want = T.tree_map(lambda t: t, halves[0][1])
    flat = [(a.float() + b.float()) / 2 for a, b in
            zip(T.leaves(halves[0][1]), T.leaves(halves[1][1]))]
    want = T.unflatten(T.flatten(want)[1], flat)
    assert abs(float(loss) - float(want_loss)) <= 1e-6
    _close(grads, want, 2.0 ** -7)


def test_data_mean_on_a_rank_mesh_matches_the_whole_batch():
    """The reduced internlm2-20b: every rank of a 2 x 2 mesh of thread
    ranks runs its data block's rows and averages the gradient over
    "data" (`launch.train.data_mean`, in place); rank 0's result against
    one rank on the whole batch: the loss within 1e-6, each gradient leaf
    within 2^-7 of its largest value (bfloat16 products over 2 rows, not
    4)."""
    cfg = TR.get("internlm2-20b").reduced()
    bundle = build(cfg)
    params = bundle.init(torch.Generator().manual_seed(1), device="cpu")
    batch = _batch(cfg.vocab)
    rows = M.batch_shardings_for(M.make_production_mesh(), batch)

    def rank(m):
        shard = T.tree_map(lambda s: M.Sharding(m, s.spec), rows)
        local = M.local_views(batch, shard, m.coords())
        return TT.value_and_grad(bundle, params, local, m)

    out = M.run_mesh_threads((2, 2), ("data", "model"), rank)
    (loss, _), grads = TT.value_and_grad(bundle, params, batch)
    assert abs(float(out[0][0][0]) - float(loss)) <= 1e-6
    _close(out[0][1], grads, 2.0 ** -7)
    _close(out[3][1], out[0][1], 0.0)        # every rank holds one mean


def test_microbatches_accumulate_in_float32():
    cfg = TR.get("internlm2-20b").reduced()
    bundle = build(cfg)
    params = bundle.init(torch.Generator().manual_seed(2), device="cpu")
    batch = _batch(cfg.vocab)
    (l2, _), g2 = TT.accumulate(bundle, params, batch, None, 2)
    halves = [TT.value_and_grad(bundle, params, {k: v[i * 2:(i + 1) * 2]
                                                 for k, v in batch.items()})
              for i in range(2)]
    assert all(t.dtype == torch.float32 for t in T.leaves(g2))
    for g, a, b in zip(T.leaves(g2), T.leaves(halves[0][1]),
                       T.leaves(halves[1][1])):
        assert torch.equal(g, (a.float() + b.float()) / 2)
    assert float(l2) == float((halves[0][0][0] + halves[1][0][0]) / 2)


# ------------------------------------------------ (g) kernel meta paths --

def _kernel_cases():
    from repro_torch.compression.kv import kv_quantizer_config, quantize_kv
    from repro_torch.core import codec as C
    from repro_torch.core.config import QuantizerConfig
    from repro_torch.kernels import dense, kv_attention as KA, lossless, pack
    cfg_a = QuantizerConfig(mode="abs", error_bound=1e-3, bin_bits=16)
    cfg_r = QuantizerConfig(mode="rel", error_bound=1e-3, bin_bits=16)
    n = 3000
    x = torch.randn(n)
    eb = torch.tensor([1e-3])
    words, _ = pack.abs_pack(x, eb, cfg_a)
    rwords, _, signs = pack.rel_pack(x, cfg_r)
    header, lc_payload, _ = lossless.lc_select(words[None], "narrow")
    qa = dense.quantize_abs(x, cfg_a)
    qr = dense.quantize_rel(x, cfg_r)
    payload = torch.zeros(n, dtype=torch.int32)
    kv_cfg = kv_quantizer_config()
    kq = quantize_kv(torch.randn(2, 2, 256, 128), kv_cfg)
    vq = quantize_kv(torch.randn(2, 2, 256, 128), kv_cfg)
    q = torch.randn(2, 2, 3, 128)
    lens = torch.tensor([200, 7], dtype=torch.int32)
    return {
        "_abs_pack": (pack, pack.abs_pack, (x, eb, cfg_a)),
        "_rel_pack": (pack, pack.rel_pack, (x, cfg_r)),
        "_abs_unpack": (pack, pack.abs_unpack, (words, eb, n, cfg_a)),
        "_rel_unpack": (pack, pack.rel_unpack, (rwords, signs, n, cfg_r)),
        "_abs_pack_lc": (lossless, lossless.abs_pack_lc,
                         (x, eb, cfg_a, "narrow")),
        "_rel_pack_lc": (lossless, lossless.rel_pack_lc,
                         (x, cfg_r, "zero")),
        "_lc_select": (lossless, lossless.lc_select,
                       (words[None], "narrow")),
        "_lc_expand": (lossless, lossless.lc_expand,
                       (header, lc_payload, words.shape[0])),
        "_quantize_abs": (dense, dense.quantize_abs, (x, cfg_a)),
        "_quantize_rel": (dense, dense.quantize_rel, (x, cfg_r)),
        "_dequantize_abs": (dense, dense.dequantize_abs,
                            (qa.bins, payload, qa.outlier, cfg_a)),
        "_dequantize_rel": (dense, dense.dequantize_rel,
                            (qr.bins, payload, qr.outlier, qr.sign, cfg_r)),
        "_kv_decode_attention": (KA, KA.kv_decode_attention,
                                 (q, kq, vq, lens)),
    }, C


def _to_meta(a):
    if torch.is_tensor(a):
        return a.to("meta")
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_to_meta(v) for v in a))
    return a


@pytest.mark.parametrize("name", sorted(DR.B_NUMBERS))
def test_kernel_wrapper_meta_path(name, monkeypatch):
    """On meta a wrapper gives its plain version's shapes and dtypes,
    counts one launch, and runs neither its plain version nor the card's
    library."""
    cases, _ = _kernel_cases()
    mod, fn, args = cases[name]
    want = fn(*args)                                   # the CPU's plain path
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("library"))
    for attr in dir(mod):
        if attr.endswith("_plain"):
            monkeypatch.setattr(mod, attr, lambda *a, **k: pytest.fail(
                "plain version on meta"))
    before = dict(mod.LAUNCHES)
    got = fn(*(_to_meta(a) for a in args))
    after = dict(mod.LAUNCHES)
    assert after[name] == before[name] + 1
    assert all(after[k] == before[k] for k in after if k != name)
    flat = lambda o: [t for t in T.leaves(o) if torch.is_tensor(t)]
    assert [(t.shape, t.dtype) for t in flat(got)] == [
        (t.shape, t.dtype) for t in flat(want)]
    assert all(t.device.type == "meta" for t in flat(got))
