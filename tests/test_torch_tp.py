"""Serving on the reference's sharded layout (`launch.mesh.param_blocks`,
`gather_dim`, `cache_layouts`; `models.transformer.rank_layout`;
`models.serve._serve_tp`; `core.axis.all_gather_dim`) against the port's
one-rank paths and the JAX package's jitted single-device `forward`.

Every rank holds its block of the weights under `param_shardings`
(FSDP's "embed" over the data axes, heads / mlp / vocab / experts over
"model") and its block of the decode cache under `cache_layouts` (the
batch over the data axes, the sequence over "model"), as views or copies
of one global tree.  Ranks are threads (`launch.mesh.run_mesh_threads`)
on the meshes (2, 2) ("data", "model"), (1, 4) and (2, 1, 2) ("pod",
"data", "model"); each data rank gets one row of the batch, so the
references run row by row (a MoE layer's capacity follows the tokens a
rank routes, as the reference's does over its data shards).

What is held:
  * each rank's views have `param_shardings`' block shapes, and a tree of
    other shapes raises (no fallback to whole weights);
  * the mesh forward in float32 within F32_TOL of max |logit| of the
    reference's jitted forward and of the port's one-rank forward (the
    MoE config with the reference's expert choices forced into both port
    runs, `moe._top_k_experts`, the port's own differing only at near
    ties: C-port-6); in bfloat16 within BF16_TOL (the EP tests'
    tolerance) of the one-rank forward, with its choices given to the
    ranks;
  * 16 quantized and 16 raw decode steps (the quantized ones across a
    page close, with ranks whose local length is 0) within DECODE_TOL of
    one rank's steps (a (1, 1) mesh: the MoE decode path, which drops no
    pair), layer 0's closed pages and hot page bit-equal plane by plane,
    and each rank's cache bytes equal to `layout_bytes`;
  * rank 0's decode step counted on meta (`MetaAxis`) against the same
    step on a thread rank: FLOPs and collective bytes equal;
  * three planted faults each fail a check: a page-to-rank map shifted by
    one page, the psum after `wo` left out, and the KV heads' seam taken
    before the gather over "model".

torch runs on one thread (`test_torch_moe.one_thread`); the reference's
forward is jitted once per config, in float32.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import tree as T
from repro_torch.compression import kv as TKV
from repro_torch.configs import registry as TR
from repro_torch.core.axis import RecordingAxis
from repro_torch.kernels import kv_attention as KA
from repro_torch.launch import cost
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.models import build as t_build
from repro_torch.models import moe as TM
from repro_torch.models import serve as TS
from repro_torch.models import transformer as TT
from repro_torch.configs.base import ArchConfig as TArch

from test_torch_moe import one_thread  # noqa: F401  (autouse fixture)

NAMES = ("internlm2-20b", "chatglm3-6b", "olmoe-1b-7b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
SEQ = 32                 # prefill tokens a row
F32_TOL = 1e-5           # of max |logit|, float32 weights
BF16_TOL = 2e-2          # of max |logit|: the EP and serving tests' limit
DECODE_TOL = 2.0 ** -4   # of max |logit|, the mesh steps against one rank's
NEAR_TIE = 2.0 ** -4     # a near tie: the two experts' probabilities' ratio
STEPS = 16
KV_CFG = TKV.kv_quantizer_config()


# ------------------------------------------------------------ fixtures --

def _to_jax(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.fixture(scope="module")
def models():
    """{name: (reference cfg, port cfg, reference params, port params)}:
    the port's weights from a seed, the same values carried to the
    reference (every bfloat16 exact in float32)."""
    out = {}
    for i, name in enumerate(NAMES):
        jc, tc = JR.get(name).reduced(), TR.get(name).reduced()
        tp = t_build(tc).init(torch.Generator().manual_seed(70 + i),
                              device="cpu")
        jp = {k: ({kk: _to_jax(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else _to_jax(v))
              for k, v in tp.items()}
        assert j_build(jc).n_params() == t_build(tc).n_params()
        out[name] = (jc, tc, jp, tp)
    return out


def _cut(tc, tp, n_layers: int) -> tuple:
    """The first n_layers of a config and its weights (the decode tests'
    depth: every layer runs the same code)."""
    return (dataclasses.replace(tc, n_layers=n_layers),
            dict(tp, layers={k: v[:n_layers]
                             for k, v in tp["layers"].items()}))


_JITTED: dict = {}
_ROUTES: list = []


def _wrapped_route(real):
    def route(x_flat, router_w, top_k):
        out = real(x_flat, router_w, top_k)
        jax.debug.callback(lambda gi: _ROUTES.append(np.asarray(gi)),
                           out[1], ordered=True)
        return out
    return route


def reference_rows(jc, jp, toks: np.ndarray, dtype) -> tuple:
    """The reference's jitted single-device forward of each row of toks
    [R, S] alone in `dtype` (its stack's DTYPE for the trace): (logits
    float32 [R, S, V], the expert choices of each row's calls)."""
    key = (jc.name, dtype)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(
            lambda p, t: JT.forward(jc, p, t, None, remat=False)[0])
    if dtype == jnp.float32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    real_dtype, real_route = JT.DTYPE, JM._route
    JT.DTYPE, JM._route = dtype, _wrapped_route(real_route)
    try:
        rows, routes = [], []
        for r in range(toks.shape[0]):
            _ROUTES.clear()
            lg = _JITTED[key](jp, jnp.asarray(toks[r:r + 1], jnp.int32))
            rows.append(np.asarray(lg.astype(jnp.float32))[0])
            jax.effects_barrier()
            routes.append(list(_ROUTES))
    finally:
        JT.DTYPE, JM._route = real_dtype, real_route
    return np.stack(rows), routes


class Forced:
    """`moe._top_k_experts` giving each thread the choices recorded for
    its key (`local.key`), call by call, cut to its rows (`local.rows`);
    or, with `routes` None, recording each key's own choices.  Where the
    port's own choices differ from the given ones the ratio of the two
    weakest probabilities is kept (`tie`): a near tie is within
    NEAR_TIE of 1."""

    def __init__(self, routes=None):
        self.real, self.routes = TM._top_k_experts, routes
        self.seen: dict = {}
        self.local = threading.local()
        self.tie = 1.0
        self.lock = threading.Lock()

    def start(self, key, rows=slice(None)):
        self.local.key, self.local.rows, self.local.calls = key, rows, 0

    def __call__(self, probs, top_k):
        own = self.real(probs, top_k)
        key, i = self.local.key, self.local.calls
        self.local.calls = i + 1
        if self.routes is None:
            with self.lock:
                self.seen.setdefault(key, []).append(own)
            return own
        want = torch.as_tensor(np.array(self.routes[key][i]),
                               dtype=own.dtype)[self.local.rows]
        differ = (own != want).any(-1)
        if bool(differ.any()):
            r = (probs.gather(1, want).amin(-1)
                 / probs.gather(1, own).amin(-1))[differ]
            with self.lock:
                self.tie = min(self.tie, float(torch.minimum(r, 1 / r).min()))
        return want


def _dp(mesh) -> int:
    return int(np.prod([mesh.sizes[a] for a in M.data_axes(mesh)]))


def _data_index(mesh) -> int:
    c, i = mesh.coords(), 0
    for a in M.data_axes(mesh):
        i = i * mesh.sizes[a] + c[a]
    return i


def _rel(a, b, ref) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    ref = torch.as_tensor(ref).float()
    return float((a - b).abs().max() / ref.abs().max())


def mesh_forward(tc, tp, toks, mesh_key, forced=None):
    """Every rank's (data index, logits float32) of the layout's forward,
    each data rank on its row of toks."""
    shape, names = MESHES[mesh_key]
    axes = t_build(tc).axes()

    def rank(m):
        di = _data_index(m)
        if forced is not None:
            forced.start(di)
        blk = M.param_blocks(tp, m, axes)
        with torch.no_grad():
            lg, _ = TT.forward(tc, blk, torch.from_numpy(toks[di:di + 1]), m)
        return di, m.coords(), lg.float()[0]

    return M.run_mesh_threads(shape, names, rank)


def _tokens(tc, rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, tc.vocab, (rows, SEQ)).astype(np.int32)


# ------------------------------------------------------- param blocks --

@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_param_blocks_are_param_shardings_blocks(models, mesh_key):
    """Each rank's views have the block shapes of `param_shardings` (the
    "embed" dims over the data axes, heads / mlp / vocab / experts over
    "model"), are views of the global weights, and their bytes are
    `layout_bytes`; weights of another shape raise, whole weights take
    the whole-weight path (`rank_layout` None)."""
    shape, names = MESHES[mesh_key]
    desc = M.Mesh(shape, names)
    for name in NAMES:
        tc, tp = models[name][1], models[name][3]
        b = t_build(tc)
        shard = M.param_shardings(desc, b.axes(), tp)
        for coords in M.mesh_coords(desc):
            blk = M.param_blocks(tp, desc, b.axes(), coords)
            for g, v, s in zip(T.leaves(tp), T.leaves(blk), T.leaves(shard)):
                assert tuple(v.shape) == M.block_shape(g.shape, s)
                assert v.untyped_storage().data_ptr() == \
                    g.untyped_storage().data_ptr()
            assert DR.layout_bytes(tp, shard) == cost.tree_bytes(blk)
        spec = shard["layers"]["wq"].spec
        assert spec[1] == (("pod", "data") if "pod" in names else "data")
        assert spec[2] == "model"

    def check(m):
        tc, tp = models["olmoe-1b-7b"][1], models["olmoe-1b-7b"][3]
        axes = t_build(tc).axes()
        blk = M.param_blocks(tp, m, axes)
        assert TT.rank_layout(tc, blk, m) is not None
        assert TT.rank_layout(tc, tp, m) is None
        # whole weights but the experts, their block over "model" alone
        # (the train cells' layout), whatever the "embed" dim's spec
        experts = M.local_views(tp, DR.expert_blocks(
            desc, axes, M.param_shardings(desc, axes, tp)), m.coords())
        assert experts["layers"]["w1"].shape[1] == (
            tc.moe_experts // m.sizes["model"])
        assert TT.rank_layout(tc, experts, m) is None
        wrong = dict(blk, emb=tp["emb"][:3])
        with pytest.raises(ValueError, match="neither whole nor"):
            TT.rank_layout(tc, wrong, m)

    M.run_mesh_threads(shape, names, check)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_hybrid_runs_on_whole_weights_and_expert_blocks(mesh_key):
    """The hybrid (reduced jamba, shapes on meta) is taken whole, or whole
    but for its MoE FFNs' experts (5-dim leaves: period, block, experts,
    ...) over "model" alone, as the train cells hold it; its blocks under
    `param_shardings` raise (its layout waits)."""
    tc = TR.get("jamba-1.5-large-398b").reduced()
    b = t_build(tc)
    with torch.device("meta"):
        mp = b.abstract_params()
    shape, names = MESHES[mesh_key]
    desc, axes = M.Mesh(shape, names), b.axes()
    lay = DR.expert_blocks(desc, axes, M.param_shardings(desc, axes, mp))

    def check(m):
        assert TT.rank_layout(tc, mp, m) is None
        experts = M.local_views(mp, lay, m.coords())
        assert experts["periods"]["moe_ffn"]["w1"].shape[2] == (
            tc.moe_experts // m.sizes["model"])
        assert TT.rank_layout(tc, experts, m) is None
        with pytest.raises(NotImplementedError, match="hybrid"):
            TT.rank_layout(tc, M.param_blocks(mp, m, axes), m)

    M.run_mesh_threads(shape, names, check)


# -------------------------------------------------------- the forward --

F32_CASES = [("internlm2-20b", "1x4"), ("chatglm3-6b", "2x2"),
             ("olmoe-1b-7b", "2x1x2")]


@pytest.mark.parametrize("name,mesh_key", F32_CASES)
def test_forward_float32_matches_reference_and_one_rank(models, name,
                                                        mesh_key,
                                                        monkeypatch):
    """Float32 weights: every rank's "vocab" block of the logits within
    F32_TOL of max |logit| of the reference's jitted forward and of the
    port's one-rank forward on its row."""
    jc, tc, jp, tp = models[name]
    tp = T.tree_map(lambda t: t.float(), tp)
    monkeypatch.setattr(TT, "DTYPE", torch.float32)
    rows = _dp(M.Mesh(*MESHES[mesh_key]))
    toks = _tokens(tc, rows, 11)
    ref, routes = reference_rows(jc, jp, toks, jnp.float32)
    forced = Forced(routes) if tc.family == "moe" else None
    if forced is not None:
        monkeypatch.setattr(TM, "_top_k_experts", forced)
    one = []
    for r in range(rows):
        if forced is not None:
            forced.start(r)
        with torch.no_grad():
            one.append(TT.forward(tc, tp, torch.from_numpy(toks[r:r + 1]),
                                  None)[0].float()[0])
    for r in range(rows):
        assert _rel(one[r], ref[r], ref[r]) <= F32_TOL
    out = mesh_forward(tc, tp, toks, mesh_key, forced)
    assert len(out) == 4
    for di, coords, lg in out:
        m = M.Mesh(*MESHES[mesh_key])
        n = ref.shape[-1] // m.sizes["model"]
        lo = coords["model"] * n
        assert lg.shape == (SEQ, n)
        assert _rel(lg, ref[di][:, lo:lo + n], ref[di]) <= F32_TOL
        assert _rel(lg, one[di][:, lo:lo + n], one[di]) <= F32_TOL
    if forced is not None:
        assert forced.tie >= 1 - NEAR_TIE, forced.tie


# every config on two meshes, every mesh with two configs
BF16_CASES = [("internlm2-20b", "2x2"), ("chatglm3-6b", "2x1x2"),
              ("olmoe-1b-7b", "1x4")]


@pytest.mark.parametrize("name,mesh_key", BF16_CASES)
def test_forward_bfloat16_matches_one_rank(models, name, mesh_key,
                                           monkeypatch):
    """The bfloat16 weights the card serves: every rank's block within
    BF16_TOL of max |logit| of the one-rank forward on its row (which
    tests/test_torch_serve.py and test_torch_moe.py hold to the
    reference's within the same limit); the MoE config with the one-rank
    run's expert choices given to the ranks (their own differing only at
    near ties)."""
    _, tc, _, tp = models[name]
    rows = _dp(M.Mesh(*MESHES[mesh_key]))
    toks = _tokens(tc, rows, 12)
    forced = Forced() if tc.family == "moe" else None
    if forced is not None:
        monkeypatch.setattr(TM, "_top_k_experts", forced)
    one = []
    for r in range(rows):
        if forced is not None:
            forced.start(r)
        with torch.no_grad():
            one.append(TT.forward(tc, tp, torch.from_numpy(toks[r:r + 1]),
                                  None)[0].float()[0])
    if forced is not None:
        forced.routes = forced.seen
    for di, coords, lg in mesh_forward(tc, tp, toks, mesh_key, forced):
        n = lg.shape[-1]
        lo = coords["model"] * n
        assert _rel(lg, one[di][:, lo:lo + n], one[di]) <= BF16_TOL
    if forced is not None:
        assert forced.tie >= 1 - NEAR_TIE, forced.tie


# ------------------------------------------------------- the decode --

def seeded_cache(bundle, batch: int, seq: int, pos0: int, quant: bool,
                 seed: int):
    """A global cache with a seeded history before pos0: K, V =
    N(0,1) * 0.7, the closed pages quantized, the open page's tokens in
    the hot page (raw: every token in the cache)."""
    tc = bundle.cfg
    g = torch.Generator().manual_seed(seed)
    cache = bundle.make_cache(batch, seq, quant, device="cpu")
    if not quant:
        for c in cache:
            c[:, :, :pos0] = (torch.randn(c[:, :, :pos0].shape, generator=g)
                              * 0.7).to(c.dtype)
        return cache
    pages, n = divmod(pos0, TS.PAGE)
    for qkv in (cache.k, cache.v):
        x = torch.randn((tc.n_layers, batch, tc.n_kv_heads, pages * TS.PAGE,
                         tc.head_dim), generator=g) * 0.7
        q = TKV.quantize_kv(x, KV_CFG)
        qkv.bins[:, :, :, :pages * TS.PAGE] = q.bins
        for f in ("eb2", "out_idx", "out_val", "overflow"):
            getattr(qkv, f)[:, :, :, :pages] = getattr(q, f)
    for hot in (cache.hot_k, cache.hot_v):
        hot[:, :, :n] = (torch.randn(hot[:, :, :n].shape, generator=g)
                         * 0.7).to(hot.dtype)
    return cache


def run_decode(tc, tp, glob, toks, pos0: int, mesh_shape, names, forced=None,
               on_rank=None):
    """Every rank's (coords, [logits of each step], its cache block) of
    the layout's steps from pos0, each rank on a copy of its block of
    `glob` (held against `make_cache(..., mesh=)`'s shapes)."""
    axes = t_build(tc).axes()
    desc = M.Mesh(mesh_shape, names)
    b = glob.k.bins.shape[1] if isinstance(glob, TS.QuantCache) \
        else glob.k.shape[1]
    lays = M.cache_layouts(desc, glob, b)
    quant = isinstance(glob, TS.QuantCache)
    s = glob.k.bins.shape[3] if quant else glob.k.shape[2]

    def rank(m):
        di, bl = _data_index(m), b // _dp(m)
        if forced is not None:
            forced.start(None, slice(di * bl, (di + 1) * bl))
        blk = M.param_blocks(tp, m, axes)
        cache = TS.RankCache(T.tree_map(lambda t: t.clone(), M.local_views(
            glob, lays, m.coords())), b, s)
        made = t_build(tc).make_cache(b, s, quant, device="cpu", mesh=m)
        assert (made.batch, made.seq) == (b, s)
        assert [t.shape for t in T.leaves(made.block)] == \
            [t.shape for t in T.leaves(cache.block)]
        assert cost.tree_bytes(made.block) == DR.layout_bytes(glob, lays)
        out = []
        with torch.no_grad():
            for i in range(toks.shape[0]):
                out.append(TS.serve_step(tc, blk, cache,
                                         toks[i, di * bl:(di + 1) * bl],
                                         pos0 + i, m, KV_CFG)[0])
        if on_rank is not None:
            on_rank(m, blk, cache)
        return m.coords(), out, cache.block

    return M.run_mesh_threads(mesh_shape, names, rank), lays


def one_rank_steps(tc, tp, cache, toks, pos0: int, forced=None) -> list:
    """One rank's steps (a (1, 1) mesh, which splits no weight: the
    whole-weight step, with the MoE decode path) on `cache`, updated in
    place."""
    def rank(m):
        if forced is not None:
            forced.start(None)
        with torch.no_grad():
            return [TS.serve_step(tc, tp, cache, toks[i], pos0 + i, m,
                                  KV_CFG)[0] for i in range(toks.shape[0])]
    return M.run_mesh_threads((1, 1), ("data", "model"), rank)[0]


# (name, mesh, quantized, batch, seq, pos0): the quantized case has 1 page
# a rank, the history on ranks 0 and 1, page 2 closing on rank 2, rank 3
# at local length 0 throughout; eb2 split by KV head and the outlier
# planes by slot (4 pages < 4 heads < 8 slots).  The raw case crosses
# the sequence blocks' seam at 512.
# (the MoE case on one of its layers, the dense one on two: four thread
# ranks' small ops contend for the interpreter, and every layer runs the
# same code)
DECODE_CASES = [("olmoe-1b-7b", "1x4", True, 4, 512, 376, 1),
                ("internlm2-20b", "2x2", False, 4, 1024, 504, 2)]


@pytest.mark.parametrize("name,mesh_key,quant,batch,seq,pos0,layers",
                         DECODE_CASES)
def test_decode_steps_match_one_rank(models, name, mesh_key, quant, batch,
                                     seq, pos0, layers, monkeypatch):
    """16 decode steps on the layout (1 or 2 of the config's layers): logits
    within DECODE_TOL of max |logit| of one rank's steps on the same
    cache (the MoE with one rank's choices given to the ranks; its own
    only at near ties), layer 0's planes (closed pages and hot page)
    bit-equal to one rank's block, every rank's cache bytes
    `layout_bytes`."""
    tc, tp = _cut(*models[name][1:4:2], layers)
    bundle = t_build(tc)
    glob = seeded_cache(bundle, batch, seq, pos0, quant, 21)
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        0, tc.vocab, (STEPS, batch, 1)))
    forced = None
    if tc.family == "moe":
        forced = Forced()
        monkeypatch.setattr(TM, "_top_k_experts", forced)
    one_cache = T.tree_map(lambda t: t.clone(), glob)
    want = one_rank_steps(tc, tp, one_cache, toks, pos0, forced)
    if forced is not None:
        forced.routes = {None: forced.seen[None]}
    out, lays = run_decode(tc, tp, glob, toks, pos0, *MESHES[mesh_key],
                           forced)
    if quant:
        closes = [p for p in range(pos0, pos0 + STEPS)
                  if (p + 1) % TS.PAGE == 0]
        assert closes, "the steps cross no page close"
    b_l = batch // _dp(M.Mesh(*MESHES[mesh_key]))
    desc = M.Mesh(*MESHES[mesh_key])
    for coords, logits, cache in out:
        di = 0
        for a in M.data_axes(desc):
            di = di * desc.sizes[a] + coords[a]
        mine = dict(coords)
        for i, lg in enumerate(logits):
            full = want[i][di * b_l:(di + 1) * b_l]
            n = lg.shape[-1]
            lo = coords["model"] * n
            assert _rel(lg, full[:, lo:lo + n], want[i]) <= DECODE_TOL
        ref = M.local_views(one_cache, lays, mine)
        for a, w in zip(T.leaves(cache), T.leaves(ref)):
            assert torch.equal(a[0], w[0])
    if forced is not None:
        assert forced.tie >= 1 - NEAR_TIE, forced.tie


def test_rank_zero_decode_step_counts_as_on_meta(models):
    """Rank 0's quantized decode step (a 1-layer config at D = 128, B12's
    head dim on the card, on the 2 x 2 mesh,
    history on both model ranks, the hot page's token on rank 1) counted
    on meta (`MetaAxis`, rank 0's program alone) and run on the thread
    ranks: FLOPs (`FlopCounterMode` in rank 0's thread; B12's plain
    version, which the CPU runs in its place, not counted: meta and the
    card count no FLOPs inside the kernel) and collective bytes
    (`RecordingAxis` over rank 0's axes) equal."""
    tc = TArch(name="tp-d128", family="dense", n_layers=1, d_model=128,
               n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=128)
    bundle = t_build(tc)
    tp = bundle.init(torch.Generator().manual_seed(29), device="cpu")
    shape, names = MESHES["2x2"]
    pos, batch, seq = 464, 4, 512
    glob = seeded_cache(bundle, batch, seq, pos, True, 23)
    tok = torch.from_numpy(np.random.default_rng(24).integers(
        0, tc.vocab, (batch, 1)))
    desc = M.Mesh(shape, names)
    lays = M.cache_layouts(desc, glob, batch)
    card = {}

    def rank(m):
        blk = M.param_blocks(tp, m, bundle.axes())
        cache = TS.RankCache(T.tree_map(lambda t: t.clone(), M.local_views(
            glob, lays, m.coords())), batch, seq)
        toks = tok[_data_index(m) * 2:][:2]
        if m.coords() != {"data": 0, "model": 0}:
            with torch.no_grad():
                TS.serve_step(tc, blk, cache, toks, pos, m, KV_CFG)
            return
        rec = cost.Recorder()
        m0 = M.Mesh(m.shape, m.axis_names, axes={
            n: RecordingAxis(m.axis(n), rec) for n in m.axis_names})
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            TS.serve_step(tc, blk, cache, toks, pos, m0, KV_CFG)
        card.update(flops=fc.get_total_flops(), coll=dict(rec.bytes))

    real = KA._kv_decode_attention_plain

    def uncounted(*a, **kw):
        with _disable_current_modes():
            return real(*a, **kw)

    KA._kv_decode_attention_plain = uncounted
    try:
        M.run_mesh_threads(shape, names, rank)
    finally:
        KA._kv_decode_attention_plain = real
    rec = cost.Recorder()
    with torch.device("meta"):
        mp = bundle.abstract_params()
        coords = dict.fromkeys(names, 0)
        blk = M.param_blocks(mp, desc, bundle.axes(), coords)
        mcache = M.local_views(TS.make_quant_cache(tc, batch, seq,
                                                   device="meta"),
                               lays, coords)
        mtok = torch.empty((2, 1), dtype=torch.int64)
        rmesh = DR.rank_mesh(desc, rec, coords)
        _, c, _ = DR.measure(lambda: TS.serve_step(
            tc, blk, TS.RankCache(mcache, batch, seq), mtok, pos, rmesh,
            KV_CFG), {"params": blk, "cache": mcache}, rec)
    assert card["flops"] == c.flops > 0
    assert card["coll"] == c.collective_bytes
    assert set(card["coll"]) == {"all-gather", "all-reduce"}


def test_one_rank_layout_is_the_one_rank_step_bit_for_bit(models):
    """On a (1, 1) mesh the layout's step over a `RankCache`
    (`serve._serve_tp`: every collective over one rank, B12's merge rule
    over one rank's parts), with the layout's specs and with whole
    weights (`rank_layout` sends a mesh that splits nothing to whole
    weights), gives the whole-weight step's logits and cache bit for bit,
    across a page close."""
    tc, tp = _cut(*models["internlm2-20b"][1:4:2], 2)
    bundle = t_build(tc)
    glob = seeded_cache(bundle, 2, 512, 124, True, 25)
    toks = torch.from_numpy(np.random.default_rng(26).integers(
        0, tc.vocab, (6, 2, 1)))
    a = T.tree_map(lambda t: t.clone(), glob)
    with torch.no_grad():
        want = [TS.serve_step(tc, tp, a, toks[i], 124 + i, None, KV_CFG)[0]
                for i in range(6)]
    spec = TT._shardings(tc, (1, 1), ("data", "model"))[1]
    caches = [T.tree_map(lambda t: t.clone(), glob) for _ in range(2)]

    def rank(m):
        assert TT.rank_layout(tc, tp, m) is None
        b, c = (TS.RankCache(x, 2, 512) for x in caches)
        with torch.no_grad():
            return [(TS._serve_tp(tc, tp, b, toks[i], 124 + i, m, KV_CFG,
                                  spec),
                     TS.serve_step(tc, tp, c, toks[i], 124 + i, m,
                                   KV_CFG)[0]) for i in range(6)]

    got = M.run_mesh_threads((1, 1), ("data", "model"), rank)[0]
    for (x, y), w in zip(got, want):
        assert torch.equal(x, w) and torch.equal(y, w)
    for c in caches:
        for x, y in zip(T.leaves(a), T.leaves(c)):
            assert torch.equal(x, y)


def test_a_cache_that_is_not_the_ranks_block_raises(models):
    """The layout's step runs only over a `RankCache` whose blocks are
    `cache_layouts`' of its recorded batch and sequence: a whole cache
    given with the rank's parameter blocks, or a whole cache recorded as
    a rank's block (its shapes fit a block of a cache twice as large),
    raises before any step."""
    tc, tp = _cut(*models["internlm2-20b"][1:4:2], 1)
    bundle = t_build(tc)
    shape, names = MESHES["2x2"]
    tok = torch.zeros((2, 1), dtype=torch.int64)

    def rank(m):
        blk = M.param_blocks(tp, m, bundle.axes())
        whole = bundle.make_cache(4, 1024, device="cpu")
        with pytest.raises(ValueError, match="RankCache"):
            TS.serve_step(tc, blk, whole, tok, 5, m)
        with pytest.raises(ValueError, match="not a rank's block"):
            TS.serve_step(tc, blk, TS.RankCache(whole, 4, 1024), tok, 5, m)
        with pytest.raises(TypeError, match="RankCache"):
            TS.cache_plan(tc, whole, m)
        made = bundle.make_cache(4, 1024, device="cpu", mesh=m)
        assert TS.cache_plan(tc, made, m).s == 1024

    M.run_mesh_threads(shape, names, rank)


# ----------------------------------------------------- planted faults --

def _forward_gap(models, name, mesh_key) -> float:
    """The largest gap of the bfloat16 mesh forward from the one-rank
    forward, of max |logit|."""
    _, tc, _, tp = models[name]
    rows = _dp(M.Mesh(*MESHES[mesh_key]))
    toks = _tokens(tc, rows, 13)
    gap = 0.0
    for di, coords, lg in mesh_forward(tc, tp, toks, mesh_key):
        with torch.no_grad():
            one = TT.forward(tc, tp, torch.from_numpy(toks[di:di + 1]),
                             None)[0].float()[0]
        n = lg.shape[-1]
        lo = coords["model"] * n
        gap = max(gap, _rel(lg, one[..., lo:lo + n], one))
    return gap


def test_planted_psum_left_out_after_wo_fails(models, monkeypatch):
    """`wo`'s partial products not summed over "model": the forward
    leaves BF16_TOL (a sound run is within it)."""
    assert _forward_gap(models, "internlm2-20b", "2x2") <= BF16_TOL
    monkeypatch.setattr(TT, "attn_out", lambda o, wo, entry, mesh: o @ wo)
    assert _forward_gap(models, "internlm2-20b", "2x2") > BF16_TOL


def test_planted_kv_seam_before_the_gather_fails(models, monkeypatch):
    """Each rank's `wkv` block cut into k and v before the gather over
    "model" (the block holds K and V of no whole head: one KV head on 2
    ranks, rank 0's block all K): the forward leaves BF16_TOL."""
    real = TT._gather_kv

    def seam_first(kv, entry, mesh):
        half = kv.shape[-1] // 2
        return torch.cat([real(kv[..., :half], entry, mesh),
                          real(kv[..., half:], entry, mesh)], -1)

    monkeypatch.setattr(TT, "_gather_kv", seam_first)
    assert _forward_gap(models, "internlm2-20b", "2x2") > BF16_TOL


def test_planted_page_to_rank_map_shifted_fails(models, monkeypatch):
    """The page that closes written one page further on (the next rank's
    first page): layer 0's closed pages differ from one rank's."""
    tc, tp = _cut(*models["internlm2-20b"][1:4:2], 2)
    bundle = t_build(tc)
    batch, seq, pos0, steps = 2, 512, 250, 8
    glob = seeded_cache(bundle, batch, seq, pos0, True, 27)
    toks = torch.from_numpy(np.random.default_rng(28).integers(
        0, tc.vocab, (steps, batch, 1)))
    one_cache = T.tree_map(lambda t: t.clone(), glob)
    one_rank_steps(tc, tp, one_cache, toks, pos0)
    real = TS._page_owner
    monkeypatch.setattr(TS, "_page_owner",
                        lambda page, plan: real(page + 1, plan))
    out, lays = run_decode(tc, tp, glob, toks, pos0, (1, 2),
                           ("data", "model"))
    same = []
    for coords, _, cache in out:
        ref = M.local_views(one_cache, lays, coords)
        same += [torch.equal(a[0], w[0])
                 for a, w in zip(T.leaves(cache), T.leaves(ref))]
    assert not all(same)
