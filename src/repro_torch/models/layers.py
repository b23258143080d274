"""The model layers, as plain functions on tensors (counterpart of
`repro.models.layers`: `rms_norm`, `layer_norm`, `rope_tables`,
`apply_rope`, `repeat_kv`, `flash_attention`, `decode_attention`,
`chunked_scan`, `ffn` (its "gelu" is the tanh form, as the reference's
`jax.nn.gelu(approximate=True)`), `trunc_init`, `NEG_BIG`).

The reference writes them as global math with sharding constraints at a
few seams (`ShardCtx`); on one card those constraints are the identity,
so the port has none.  On a rank of the reference's layout
(`transformer.forward` and `serve.serve_step` with the rank's parameter
blocks) four helpers do what GSPMD does there: `vocab_embed` (the
rank's "vocab" rows, a masked lookup and a psum over "model"),
`vocab_ce` (the training loss's cross-entropy from the rank's "vocab"
block of the logits: a pmax and two psums over "model"),
`row_parallel` (a product whose contracted dim is split over "model":
the rank's partial product in float32, then a psum) and `decode_attention` with
`return_stats` (a rank's sequence block, its (o, m, l) to merge across
ranks).  The reference's remat (`jax.checkpoint`) is
`transformer.forward`'s per-layer `torch.utils.checkpoint` here, which
changes no value; autograd differentiates `flash_attention` through its
block loops (the reference's `jax.grad` through its scans).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.graph import get_gradient_edge
from torch.utils.checkpoint import checkpoint

from ..launch import cost
from .params import _trunc_normal_

NEG_BIG = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5):
    """LayerNorm with bias (whisper): float32 mean and variance, rsqrt(var
    + eps), then w and b in float32; cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, -1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """positions: int [...]; returns (cos, sin) float32 [..., dim / 2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(torch.full_like(exps, base), exps)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos, sin, mode: str = "full"):
    """x: [B, S, H, hd]; cos/sin: [B or 1, S, rot / 2].  'full' rotates the
    whole head dim; 'partial' (chatglm3's 2d-RoPE) only its first half;
    'none' is the identity."""
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot = hd if mode == "full" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    c = cos[..., None, :].to(x.dtype)            # [B, S, 1, rot / 2]
    s = sin[..., None, :].to(x.dtype)
    y = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([y, xp], dim=-1) if mode == "partial" else y


def repeat_kv(kv: torch.Tensor, group_size: int) -> torch.Tensor:
    """[B, S, G, hd] -> [B, S, G * group_size, hd] (each KV head repeated
    for its query heads, in place order)."""
    if group_size == 1:
        return kv
    b, s, g, hd = kv.shape
    return kv[:, :, :, None, :].expand(b, s, g, group_size, hd).reshape(
        b, s, g * group_size, hd)


def _pick(n: int, target: int) -> int:
    """The largest divisor of n that is <= target (the reference's block
    rule: 1500 frames give blocks of 500)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return n


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024):
    """Online-softmax blocked attention over the reference's blocks.

    q: [B, Sq, H, hd]; k, v: [B, Skv, H, hd] (GQA repeat done by the
    caller).  Blocks of `_pick(Sq, q_block)` queries and `_pick(Skv,
    kv_block)` keys; per block the scores are float32 products of the
    bfloat16 inputs, scaled by 1/sqrt(hd) and set to NEG_BIG where the key
    lies after the query (every block is masked and computed, as the
    reference computes them); m, l and acc are float32, and p is cast to
    v's dtype before p v, whose products accumulate in float32.  Returns
    [B, Sq, H, hd] in q's dtype."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    qb, kb = _pick(sq, q_block), _pick(skv, kv_block)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    neg = torch.full((), NEG_BIG, device=dev)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    rows = torch.arange(qb, device=dev)[:, None]
    cols = torch.arange(kb, device=dev)[None, :]
    for qi in range(sq // qb):
        q_blk = q[:, qi * qb:(qi + 1) * qb].to(torch.float32)
        q_blk = q_blk.permute(0, 2, 1, 3)                   # [b, h, qb, hd]
        m = torch.full((b, h, qb), NEG_BIG, device=dev)
        l_ = torch.zeros((b, h, qb), device=dev)
        acc = torch.zeros((b, h, qb, hd), device=dev)
        for ki in range(skv // kb):
            k_blk = k[:, ki * kb:(ki + 1) * kb].to(torch.float32)
            v_blk = v[:, ki * kb:(ki + 1) * kb]
            s = torch.matmul(q_blk, k_blk.permute(0, 2, 3, 1)) * scale
            if causal:
                ok = (ki * kb + cols) <= (qi * qb + rows)      # [qb, kb]
                s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l_ = l_ * alpha + p.sum(-1)
            pv = torch.matmul(p.to(v_blk.dtype).to(torch.float32),
                              v_blk.to(torch.float32).permute(0, 2, 1, 3))
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / l_[..., None]
        out[:, qi * qb:(qi + 1) * qb] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     return_stats: bool = False):
    """Single-token GQA decode: q [B, 1, H, hd]; caches [B, S, G, hd];
    lengths int [B].  Grouped einsum, no KV repeat.  With return_stats
    (a rank's sequence block of the cache, lengths local to it): (o
    float32 [B, H, hd], m [B, H], l [B, H]), o = sum_s p_s v_s / l with
    p = exp(score - m), for `serve` to merge across ranks; a row with no
    token is o 0, m NEG_BIG, l 0 (no weight in the merge)."""
    b, _, h, hd = q.shape
    s, g = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, g, h // g, hd)
    scores = torch.einsum("bgqd,bsgd->bgqs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / (hd ** 0.5)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_BIG, device=q.device))
    if not return_stats:
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgqs,bsgd->bgqd", p, v_cache.to(torch.float32))
        return out.reshape(b, 1, h, hd).to(q.dtype)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None]) * valid[:, None, None, :]
    l_ = p.sum(-1)
    acc = torch.einsum("bgqs,bsgd->bgqd", p, v_cache.to(torch.float32))
    o = acc / torch.clamp(l_, min=1e-30)[..., None]
    return o.reshape(b, h, hd), l_.reshape(b, h), m.reshape(b, h)


def vocab_embed(emb: torch.Tensor, tokens: torch.Tensor, axis):
    """The embedding of `tokens` from emb [V / n, D], the rank's block of
    "vocab" rows over `axis` (n ranks, rows axis.rank * V / n on): each
    rank looks up the tokens in its rows and puts -0.0 elsewhere, then a
    psum over the axis.  A token has one rank's row and -0.0 + x = x for
    every x, so every rank gets the one-rank lookup bit for bit."""
    n = emb.shape[0]
    local = tokens.to(torch.int64) - axis.axis_index() * n
    mine = (local >= 0) & (local < n)
    rows = emb[torch.where(mine, local, torch.zeros_like(local))]
    neg0 = torch.full((), -0.0, dtype=emb.dtype, device=emb.device)
    return axis.psum(torch.where(mine[..., None], rows, neg0))


def vocab_ce(logits: torch.Tensor, labels: torch.Tensor, axis):
    """The cross-entropy lse - ll of each token from logits float32 [...,
    V / n], the rank's block of the "vocab" dim over `axis` (n ranks,
    columns axis.rank * V / n on), and int labels [...]: M is the pmax of
    the blocks' maxima (detached: lse does not depend on it), lse =
    log(psum(sum exp(l - M))) + M, and the label's logit comes from the
    rank whose columns hold it (a masked gather, -0.0 elsewhere, then a
    psum, as `vocab_embed` does).  The one-rank logsumexp less the label's
    logit within float32 reordering; the gradient reaches each rank's
    block through the psums (its softmax block less its one-hot block)."""
    n = logits.shape[-1]
    m = axis.pmax(logits.detach().amax(-1))
    s = axis.psum(torch.exp(logits - m[..., None]).sum(-1))
    lse = torch.log(s) + m
    local = labels.to(torch.int64) - axis.axis_index() * n
    mine = (local >= 0) & (local < n)
    ll = logits.gather(-1, torch.where(mine, local, torch.zeros_like(
        local))[..., None])[..., 0]
    neg0 = torch.full((), -0.0, dtype=logits.dtype, device=logits.device)
    return lse - axis.psum(torch.where(mine, ll, neg0))


class _MatmulF32(torch.autograd.Function):
    """`matmul_f32` off the CPU: one bfloat16 GEMM with a float32 output
    (which has no derivative of its own); its gradient is the float32
    product's, as the CPU form differentiates, rounded to each input's
    dtype."""

    @staticmethod
    def forward(ctx, a2, w):
        ctx.save_for_backward(a2, w)
        return torch.mm(a2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a2, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = (g @ w.to(torch.float32).t()).to(a2.dtype)
        if ctx.needs_input_grad[1]:
            gw = (a2.to(torch.float32).t() @ g).to(w.dtype)
        return ga, gw


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ w [K, N] with a float32 result that rounds no
    bfloat16 product: on the card (and meta) one bfloat16 GEMM with a
    float32 output (`torch.mm(..., out_dtype=)`), on the CPU, which has
    no such GEMM, the float32 product of the same values; the gradient
    is the float32 product's either way."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return a @ w
    a2 = a.reshape(-1, a.shape[-1])
    if a.device.type == "cpu":
        out = a2.to(torch.float32) @ w.to(torch.float32)
    else:
        out = _MatmulF32.apply(a2, w)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def row_parallel(a: torch.Tensor, w: torch.Tensor, axis) -> torch.Tensor:
    """a @ w where the contracted dim is split over `axis` (a [..., K / n]
    and w [K / n, N] the rank's blocks): the rank's partial product in
    float32 (`matmul_f32`), summed over the ranks in rank order, rounded
    once to a's dtype."""
    return axis.psum(matmul_f32(a, w)).to(a.dtype)


def chunked_scan(step, carry: tuple, xs, chunk: int = 64,
                 remat: bool = True):
    """A scan over time in chunks: step(carry, x_t) -> (carry, y_t) for t
    in order; returns (carry, ys stacked on a leading T axis).  carry is a
    tuple of tensors; xs a tensor [T, ...], or a tuple of them (the
    reference's pytree), and x_t is then the tuple of their slices at t.
    The chunk is min(chunk, T), or 1 where it does not divide T (the
    reference's rule).  While autograd records (and remat), each chunk
    runs under `torch.utils.checkpoint`: the backward pass keeps the carry
    only at chunk boundaries and replays the steps inside, which changes
    no value.

    On the meta device under `launch.cost.counting`, a scan of three
    chunks or more runs only the chunks that measure one and stands in
    for the others (`_scaled_scan`); on any other device every chunk
    runs."""
    one = torch.is_tensor(xs)
    xs = (xs,) if one else tuple(xs)
    n_x, t = len(xs), xs[0].shape[0]
    chunk = min(chunk, t)
    if t % chunk:
        chunk = 1

    def run(*args):
        xc, c = args[:n_x], args[n_x:]
        ys = []
        for i in range(xc[0].shape[0]):
            c, y = step(c, xc[0][i] if one else tuple(a[i] for a in xc))
            ys.append(y)
        return (*c, torch.stack(ys))

    def run_chunk(xc: tuple, carry: tuple) -> tuple:
        if remat and torch.is_grad_enabled():
            *carry, y = checkpoint(run, *xc, *carry, use_reentrant=False)
        else:
            *carry, y = run(*xc, *carry)
        return tuple(carry), y

    if xs[0].device.type == "meta" and t // chunk >= 3:
        meter = cost.meter()
        if meter is not None:
            return _scaled_scan(meter, step, run_chunk, tuple(carry), xs,
                                chunk, remat)
    ys = []
    for start in range(0, t, chunk):
        carry, y = run_chunk(tuple(a[start:start + chunk] for a in xs),
                             carry)
        ys.append(y)
    return carry, torch.cat(ys)


# ------------------------------------------- the scan on the meta device --
#
# The dry-run counts a scan as the reference's HLO count does: one chunk's
# cost times the number of chunks.  Chunk 0 (its carry comes from outside
# the scan) and chunk 1 each run once between `Meter.open` and `close`
# (`_measure`); every other chunk, and both of them in later scans of the
# same step, shapes and mode (`Meter.memo`), is a stand-in
# (`_stand_in`): it notes the live bytes plus the measured chunk's
# transient as a peak, credits its FLOPs, launches and collective bytes,
# and makes one storage for each the chunk leaves alive (its carry, its
# stacked y block).  While autograd records it is `_StandIn`, which keeps
# what the chunk's graph keeps: under remat its inputs and its step, as
# `checkpoint` does (so an enclosing checkpoint's recompute may meet a
# stand-in where the first pass ran the chunk), without remat the inputs,
# outputs and intermediates its steps saved (`_Saves`).  Its backward
# credits the measured chunk's backward and makes the input gradients.  A
# measured chunk's backward runs after its stand-ins' (they come later in
# the scan), so it is measured between two `_Mark`s and what the
# stand-ins owe is credited then.

def _skey(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _signature(obj, tensors: list, depth: int = 0):
    """What a chunk's cost depends on, hashable: a tensor's shape, dtype,
    strides and requires_grad, plain values, a function's code and
    closure (the tensors met appended to `tensors`, in order); None
    where it reaches anything else."""
    if torch.is_tensor(obj):
        tensors.append(obj)
        return (tuple(obj.shape), obj.dtype, obj.stride(), obj.requires_grad)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return (obj,)
    if isinstance(obj, (tuple, list)):
        out = tuple(_signature(o, tensors, depth) for o in obj)
        return None if None in out else out
    code = getattr(obj, "__code__", None)
    if code is not None and depth < 4:
        try:
            cells = [c.cell_contents for c in obj.__closure__ or ()]
        except ValueError:                   # an empty cell
            return None
        out = tuple(_signature(c, tensors, depth + 1) for c in cells)
        return None if None in out else (code, out)
    return None


def _closure_tensors(step) -> list:
    """The tensors a step reaches through its closure."""
    out = []
    _signature(step, out)
    return out


def _exits(outs, ins, params) -> list | None:
    """Which of `params` a chunk's backward sends gradients to: the
    chunk's graph, from its outputs down to the nodes made before it
    (`ins`, its inputs, passed through a `_Mark`, were the last), must
    leave only to `ins` and `params`; their indices, or None."""
    edges = lambda ts: {(id(e.node), e.output_nr) for e in
                        (get_gradient_edge(t) for t in ts if t.requires_grad)}
    s0 = max(t.grad_fn._sequence_nr() for t in ins if t.requires_grad)
    seen, todo, out = set(), [o.grad_fn for o in outs
                              if o.grad_fn is not None], set()
    while todo:
        node = todo.pop()
        for nxt, nr in node.next_functions:
            if nxt is None:
                continue
            if nxt._sequence_nr() <= s0 or type(nxt).__name__ == \
                    "AccumulateGrad":
                out.add((id(nxt), nr))
            elif id(nxt) not in seen:
                seen.add(id(nxt))
                todo.append(nxt)
    out -= edges(ins)
    used = [i for i, t in enumerate(params)
            if t.requires_grad and edges([t]) <= out]
    if out - edges([params[i] for i in used]):
        return None
    return used


class _Fwd:
    """A measured chunk's forward: its Spend, its outputs' layout (`outs`:
    per output (shape, stride, dtype, requires_grad)), the indices of the
    step's closure tensors its backward sends gradients to (`params`),
    the bytes of the intermediates its graph keeps (`extras`), and which
    of its inputs (xs and carry) and outputs its graph keeps (`keep_in`,
    `keep_out`; None: every input, as `checkpoint` keeps them)."""

    def __init__(self, spend, outs, params=(), extras=(), keep_in=None,
                 keep_out=None):
        self.spend, self.outs, self.extras = spend, outs, tuple(extras)
        self.params = tuple(params)
        self.keep_in, self.keep_out = keep_in, keep_out
        self.differentiable = any(o[3] for o in outs)


class _Plan:
    """A measured chunk (chunk 0, or chunk 1 for the chunks after it):
    `fwd` (`_Fwd`), `bwd` (the Spend of its backward) and its input
    gradients' strides, and the stand-ins' backward credits owed until
    `bwd` is measured (`owed`, and the most live bytes at any of them)."""

    def __init__(self):
        self.fwd = self.bwd = self.token = self.grad_strides = None
        self.owed, self.owed_live = 0, 0


def _outs_layout(outs, made: dict):
    """Each output's (shape, stride, dtype, requires_grad), or None where
    an output is not the whole of a storage of its own made in the
    measured chunk."""
    keys = [_skey(o) for o in outs]
    if len(set(keys)) < len(keys):
        return None
    for o, k in zip(outs, keys):
        if (k not in made or o.storage_offset()
                or o.untyped_storage().nbytes() != _span(o)):
            return None
    return [(tuple(o.shape), o.stride(), o.dtype, o.requires_grad)
            for o in outs]


def _span(t: torch.Tensor) -> int:
    """The bytes `torch.empty_strided` allocates for t's shape and
    strides."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))) \
        * t.element_size()


class _Saves(torch.autograd.graph.saved_tensors_hooks):
    """Records the storage of every tensor autograd saves inside it, and
    saves each as it is (used only where no other hooks are active)."""

    def __init__(self):
        self.keys = set()

        def pack(x):
            self.keys.add(_skey(x))
            return x

        super().__init__(pack, lambda x: x)


def _measure(meter, plan: _Plan, step, run_chunk, xc: tuple, carry: tuple,
             remat: bool):
    """Run a chunk between `Meter.open` and `close` and fill plan.fwd
    (left None where the chunk cannot stand in for others); while
    autograd records, its backward is measured between two `_Mark`s.
    Returns (carry, y)."""
    grad = torch.is_grad_enabled()
    n_x = len(xc)
    in_keys = [_skey(t) for t in xc + carry]
    saves = _Saves() if grad and not remat else contextlib.nullcontext()
    tok = meter.open()
    with saves:
        ins = xc + carry
        if grad:
            ins = _Mark.apply(plan, False, *ins)
        carry, y = run_chunk(ins[:n_x], ins[n_x:])
        raw = carry + (y,)
        outs = _Mark.apply(plan, True, *raw) if grad else raw
    spend, made = meter.close(tok)
    layout = _outs_layout(outs, made)
    kept = getattr(saves, "keys", set())
    left = set(made) - {_skey(o) for o in outs}
    params = ()
    if any(o.requires_grad for o in outs):
        params = (_exits(raw, ins, _closure_tensors(step))
                  if any(t.requires_grad for t in ins) else None)
    if layout is not None and not left - kept and params is not None:
        if grad and not remat:
            plan.fwd = _Fwd(spend, layout, params, [made[k] for k in left],
                            tuple(k in kept for k in in_keys),
                            tuple(_skey(o) in kept for o in outs))
        else:
            plan.fwd = _Fwd(spend, layout, params)
    return tuple(outs[:-1]), outs[-1]


def _scaled_scan(meter, step, run_chunk, carry: tuple, xs: tuple,
                 chunk: int, remat: bool):
    """`chunked_scan` on meta under a count.  Chunk 0 (its carry comes
    from outside the scan) and chunk 1 each run and are measured, unless
    a measurement of the same step, shapes and mode is at hand; the other
    chunks are stand-ins.  A chunk that cannot stand in for the others
    makes the chunks after it run.  Without remat while autograd records,
    a scan inside another's saved-tensor hooks (an enclosing checkpoint)
    runs every chunk: its chunk's saves cannot be told apart there."""
    grad = torch.is_grad_enabled()
    hooks = torch._C._autograd._top_saved_tensors_default_hooks(
        False) is not None
    n = xs[0].shape[0] // chunk
    plans, key = (None, None), None
    if not (grad and not remat and hooks):
        sig = _signature((step, carry, xs), []) if remat or not grad \
            else None
        key = None if sig is None else (sig, chunk, remat, grad, hooks)
        plans = meter.memo.get(key) or (_Plan(), _Plan())
    ys = []
    for i in range(n):
        plan = plans[min(i, 1)]
        xc = tuple(a[i * chunk:(i + 1) * chunk] for a in xs)
        if plan is None:
            carry, y = run_chunk(xc, carry)
        elif plan.fwd is None:
            carry, y = _measure(meter, plan, step, run_chunk, xc, carry,
                                remat)
            if plan.fwd is None:
                plans = (None, None)
        else:
            *carry, y = _stand_in(meter, plan, step, xc, carry, grad)
            carry = tuple(carry)
        ys.append(y)
    # (a chunk that records nothing saves its inputs through an enclosing
    # checkpoint's hooks only when it runs: such a scan measures afresh)
    if key is not None and None not in plans and not (grad and hooks and not
                                                      all(p.fwd.differentiable
                                                          for p in plans)):
        meter.memo[key] = plans
    return carry, torch.cat(ys)


def _dense(shape) -> tuple:
    """Contiguous strides of `shape`."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= max(int(d), 1)
    return tuple(reversed(out))


def _remake(layout) -> list:
    return [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
            for shape, stride, dtype, _ in layout]


def _stand_in(meter, plan: _Plan, step, xc: tuple, carry: tuple,
              grad: bool):
    """One chunk that is not run: (*carry, y)."""
    fwd = plan.fwd
    if not (grad and fwd.differentiable):
        meter.credit(fwd.spend)
        return _remake(fwd.outs)
    if not any(t.requires_grad for t in xc + carry):
        raise RuntimeError("chunked_scan on meta: a chunk whose outputs "
                           "need a gradient has no input that does")
    params = _closure_tensors(step)
    live = meter.tracker.live
    out = _StandIn.apply(plan, step, len(xc), *xc, *carry,
                         *[params[i] for i in fwd.params])
    # credited once its inputs are saved, as `checkpoint` saves them
    # before it runs the chunk (an enclosing checkpoint's recompute may
    # stop at that save)
    meter.credit(fwd.spend, live=live)
    return out


class _StandIn(torch.autograd.Function):
    """A chunk that is not run, while autograd records (see above)."""

    @staticmethod
    def forward(ctx, plan, step, n_x, *ins):
        fwd = plan.fwd
        outs = _remake(fwd.outs)
        keep = list(ins[:n_x + len(fwd.outs) - 1])
        if fwd.keep_in is not None:
            keep = [t for t, k in zip(keep, fwd.keep_in) if k]
            keep += [o for o, k in zip(outs, fwd.keep_out) if k]
            keep += [torch.empty(n, dtype=torch.uint8, device="meta")
                     for n in fwd.extras]
        ctx.save_for_backward(*keep)
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        # under remat the chunk's checkpoint holds the step (and what its
        # closure holds) until the chunk's backward
        ctx.step = step if fwd.keep_in is None else None
        ctx.specs = [(tuple(t.shape), t.dtype) for t in ins]
        ctx.mark_non_differentiable(*[o for o, l in zip(outs, fwd.outs)
                                      if not l[3]])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        kept = ctx.saved_tensors    # held, as the chunk's replay holds them
        plan, meter = ctx.plan, cost.meter()
        if plan.bwd is None:
            plan.owed += 1
            plan.owed_live = max(plan.owed_live, meter.tracker.live)
            meter.deferred += 1
        else:
            meter.credit(plan.bwd)
        strides = plan.grad_strides or {}
        grads = tuple(
            torch.empty_strided(shape, strides.get(i, _dense(shape)),
                                dtype=dtype, device="meta") if need else None
            for i, (need, (shape, dtype)) in enumerate(zip(
                ctx.needs_input_grad[3:], ctx.specs)))
        del kept
        ctx.step = None
        return (None, None, None) + grads


class _Mark(torch.autograd.Function):
    """Passes its inputs on as views; in backward, the one on a measured
    chunk's outputs (`opens`) opens a window and the one on its inputs
    closes it: the chunk's backward is the plan's `bwd`, the input
    gradients must be what the stand-ins make, and what the stand-ins
    owe is credited."""

    @staticmethod
    def forward(ctx, plan, opens, *ts):
        ctx.plan, ctx.opens = plan, opens
        ctx.set_materialize_grads(False)
        ctx.inputs = [(tuple(t.shape), t.dtype, t.requires_grad) for t in ts]
        out = tuple(t.view_as(t) for t in ts)
        ctx.mark_non_differentiable(*[o for o, t in zip(out, ts)
                                      if not t.requires_grad])
        return out

    @staticmethod
    def backward(ctx, *grads):
        plan, meter = ctx.plan, cost.meter()
        if ctx.opens:
            plan.token = meter.open()
            return (None, None) + grads
        spend, made = meter.close(plan.token)
        keys, strides = set(), {}
        for i, (g, (shape, dtype, rg)) in enumerate(zip(grads, ctx.inputs)):
            fresh = (g is not None and tuple(g.shape) == shape
                     and g.dtype == dtype and not g.storage_offset()
                     and _skey(g) in made and _skey(g) not in keys
                     and g.untyped_storage().nbytes() == _span(g)
                     == g.numel() * g.element_size())
            if rg and not fresh or not rg and g is not None:
                raise RuntimeError(
                    "chunked_scan on meta: a chunk's input gradient is not "
                    f"a dense tensor of its own ({shape}, {dtype}); the "
                    "stand-in chunks cannot make it")
            if g is not None:
                keys.add(_skey(g))
                strides[i] = g.stride()
        plan.bwd, plan.grad_strides = spend, strides
        if plan.owed:
            meter.credit(spend, plan.owed, plan.owed_live)
            meter.deferred -= plan.owed
            plan.owed = plan.owed_live = 0
        return (None, None) + grads


class _Silu(torch.autograd.Function):
    """`jax.nn.silu` as XLA runs it, every op rounded to x's dtype: s = 1 /
    (1 + exp(-x)), y = x s; the gradient g s + (g x)(s (1 - s)), the
    transpose of `lax.logistic`'s JVP rule."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """The reference's silu bit for bit (in bfloat16 `F.silu` rounds once
    and differs in the last bit on about a third of the values)."""
    return _Silu.apply(x)


def ffn_hidden(x, w1, w3, act: str = "swiglu"):
    """The FFN's hidden activations (before w2)."""
    if act == "swiglu":
        return silu(x @ w1) * (x @ w3)
    return F.gelu(x @ w1, approximate="tanh")    # gelu (whisper)


def ffn(x, w1, w3, w2, act: str = "swiglu"):
    return ffn_hidden(x, w1, w3, act) @ w2


def trunc_init(generator: torch.Generator, shape, dtype, scale=0.02):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return (_trunc_normal_(t, generator) * scale).to(dtype)
