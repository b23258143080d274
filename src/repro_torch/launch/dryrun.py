"""The dry-run on the production meshes (counterpart of
`repro.launch.dryrun`): every (arch x shape) cell on the 256-chip (16, 16)
("data", "model") mesh and the 512-chip (2, 16, 16) ("pod", "data",
"model") mesh, with what one rank holds and spends, and nothing
allocated.

The reference lowers and compiles each cell's jitted step under
shardings and reads XLA's memory and cost analyses.  Here rank 0 runs its
own program on the "meta" device: its params, optimizer state, caches
and batch are meta tensors of the shapes it holds; every mesh axis is a
`core.axis.MetaAxis` (collectives return empty tensors and record their
bytes); each kernel wrapper counts its launch and returns empty outputs.
`launch.cost.counting` counts the FLOPs, the peak of live bytes and the
collective bytes while the program runs.

What a rank holds (`held_bytes`) beside the reference's layout
(`layout_bytes`, its `arg_bytes`):
  * params: the dense, vlm and MoE families' cells (`LAYOUT_FAMILIES`:
    train, gradcomp, prefill and decode) hold and run the reference's
    layout, the rank's blocks under `mesh.param_shardings` (FSDP over
    the data axes, heads / mlp / vocab / experts over "model"; gradcomp
    with "pod" dropped, `drop_pod`: FSDP over "data" inside each pod,
    the pods' replicas), so held equals layout; the hybrid, encdec and
    ssm cells hold them whole but for the MoE experts, of which the rank
    holds its block over "model" (their layouts wait for a later slice);
  * optimizer state (train): AdamW's mu, nu and float32 master of the
    params the rank holds (on the layout its blocks: ZeRO's);
  * caches: on the layout families the rank's block under the
    reference's decode-cache layout (`mesh.cache_layouts`: the data axes
    on the batch, "model" on the sequence), else its block over the data
    axes only; the batch (tokens) its block over the data axes of the
    reference's `_greedy_sharding` (`greedy_sharding`; the reference also
    puts "model" on a prefill's sequence, where the port's activations
    stay whole over "model");
  * gradcomp: the pod-stacked float32 residuals the compressed step
    takes (on the layout of the rank's blocks), and the batch of the
    rank's rows over "data" from which pod 0 takes its rows.

The programs (`cell_program`): train runs the loss, its gradient over
`MICROBATCHES` slices (float32 sums / micro; on the layout each layer
rematerialized, the FSDP gather's backward a reduce-scatter, then the
replicated leaves' sums), the data mean and AdamW
(`launch.train.make_train_step`, donating the state); gradcomp the
compressed step over a MetaAxis "pod" (`make_train_step_compressed`);
prefill `ModelBundle.prefill`; decode `ModelBundle.serve_step` at
position seq_len - 1, raw or (kvq) over the quantized cache.  A cell
that stops (a host sync such as `nonzero`, `.item()` or `.tolist()`, an
op with no meta kernel, or a trace past `--budget-s`) is recorded loudly
with the op and the port's file:line where it stopped, and `main`
exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape decode_32k --mesh single --variant kvq
  PYTHONPATH=src python -m repro_torch.launch.dryrun --variant all \\
      --jobs 6                      # every cell, mesh and variant
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
Records go to results/dryrun_torch/<mesh>.<arch>.<shape>[.<variant>].json
(cached; --force runs again).  `fits` holds peak_bytes against the card's
memory (`torch.cuda.get_device_properties(0).total_memory`) or, with no
card, against --hbm-bytes (null without it).
"""
from __future__ import annotations

import argparse
import json
import re
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import tree as T
from ..compression.grads import GradCompressionConfig
from ..compression.kv import kv_quantizer_config
from ..configs import registry
from ..configs.base import SHAPES, runnable
from ..core.axis import MetaAxis
from ..models import build
from ..models.serve import RankCache
from ..models.transformer import LAYOUT_FAMILIES
from ..optim import optimizer as opt
from . import cost
from . import mesh as M
from .train import init_residuals, make_train_step, make_train_step_compressed

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
PORT_ROOT = Path(__file__).resolve().parents[1]

# Gradient-accumulation factor per arch for train_4k (the reference's
# `MICROBATCHES`, chosen there so the activation peak fits a 16 GiB chip)
MICROBATCHES = {
    "deepseek-67b": 4,
    "chameleon-34b": 4,
    "internlm2-20b": 2,
    "qwen3-moe-235b-a22b": 8,
    "jamba-1.5-large-398b": 8,
    "olmoe-1b-7b": 2,
}

# kernel wrapper launch counter -> the TPU kernel's number (PERF.md §6)
B_NUMBERS = {
    "_abs_pack": "B1", "_abs_unpack": "B2", "_rel_pack": "B3",
    "_rel_unpack": "B4", "_abs_pack_lc": "B5a", "_rel_pack_lc": "B5b",
    "_lc_select": "B6", "_lc_expand": "B7", "_quantize_abs": "B8",
    "_quantize_rel": "B9", "_dequantize_abs": "B10",
    "_dequantize_rel": "B11", "_kv_decode_attention": "B12",
}
VARIANTS = ("baseline", "kvq", "gradcomp")


def all_cells() -> list:
    """Every runnable (arch, shape), archs sorted (the reference's)."""
    cells = []
    for arch in sorted(registry.ARCHS):
        cfg = registry.get(arch)
        for shape_name, shape in SHAPES.items():
            if runnable(cfg, shape):
                cells.append((arch, shape_name))
    return cells


# ----------------------------------------------------------- layouts --

def _map_leaves(fn, tree):
    leaves, treedef = T.flatten(tree)
    return T.unflatten(treedef, [fn(t) for t in leaves])


def batch_layouts(mesh: M.Mesh, tree):
    """The reference's `_batch_shardings`: greedy, no batch size."""
    return _map_leaves(lambda t: M.greedy_sharding(mesh, t.shape), tree)


def drop_pod(s: M.Sharding) -> M.Sharding:
    """The reference gradcomp's pod-replicated params and optimizer state:
    "pod" taken out of every spec entry ("pod" alone becomes "data")."""
    spec = []
    for e in s.spec:
        if e == "pod" or e == ("pod",):
            e = "data"
        elif isinstance(e, tuple):
            e = tuple(a for a in e if a != "pod")
            e = None if e == () else (e[0] if len(e) == 1 else e)
        spec.append(e)
    return M.Sharding(s.mesh, tuple(spec))


def _names(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def data_only(s: M.Sharding) -> M.Sharding:
    """What the port's rank holds of a batch or cache leaf laid out by `s`:
    its block over the data axes only."""
    keep = []
    for e in s.spec:
        names = tuple(a for a in _names(e) if a in ("pod", "data"))
        keep.append(None if not names else
                    (names[0] if len(names) == 1 else names))
    return M.Sharding(s.mesh, tuple(keep))


def expert_blocks(mesh: M.Mesh, axes_tree, pspecs):
    """What the port's rank holds of each param: the experts' dim of an
    expert weight over "model" as `param_shardings` gives it, every other
    dim and every other leaf whole."""
    def one(ax, s):
        spec = tuple(e if a == "experts" else None
                     for a, e in zip(ax, s.spec))
        return M.Sharding(mesh, spec + (None,) * (len(ax) - len(spec)))
    return M._map_axes(one, axes_tree, pspecs)


def layout_bytes(tree, shardings, dtype=None) -> int:
    """Bytes of a rank's blocks of every leaf of `tree` under `shardings`
    (each leaf in `dtype` where given)."""
    leaves, _ = T.flatten(tree)
    shards, _ = T.flatten(shardings)
    total = 0
    for t, s in zip(leaves, shards):
        size = (torch.tensor([], dtype=dtype) if dtype is not None
                else t).element_size()
        n = int(np.prod(M.block_shape(t.shape, s), dtype=np.int64))
        total += n * size
    return total


def rank_mesh(desc: M.Mesh, recorder, coords=None) -> M.Mesh:
    """The mesh of the rank at `coords` (default rank 0) of `desc`: a
    MetaAxis per axis, all recording into `recorder`."""
    coords = coords or dict.fromkeys(desc.axis_names, 0)
    return M.Mesh(desc.shape, desc.axis_names, axes={
        n: MetaAxis(desc.sizes[n], recorder, coords[n])
        for n in desc.axis_names})


def _rank0(tree, shardings):
    return M.local_views(tree, shardings, dict.fromkeys(
        next(iter(T.leaves(shardings))).mesh.axis_names, 0))


# ----------------------------------------------------------- programs --

def cell_program(arch_name: str, shape_name: str, desc: M.Mesh,
                 variant: str, recorder, coords=None):
    """(fn, held, layout) for the rank at `coords` (default rank 0) of
    `desc`: fn() runs the cell's program; held {group: tree the program
    is given}; layout {group: bytes of the reference's layout a rank}."""
    cfg = registry.get(arch_name)
    shape = SHAPES[shape_name]
    bundle = build(cfg)
    coords = coords or dict.fromkeys(desc.axis_names, 0)
    rmesh = rank_mesh(desc, recorder, coords)
    abstract = bundle.abstract_params()
    axes = bundle.axes()
    pspecs = M.param_shardings(desc, axes, abstract)
    on_layout = cfg.family in LAYOUT_FAMILIES
    gradcomp = shape.kind == "train" and variant == "gradcomp"
    if gradcomp:
        if "pod" not in desc.axis_names:
            raise ValueError("gradcomp needs the multi-pod mesh")
        pspecs = T.tree_map(drop_pod, pspecs)
    if on_layout:
        params = M.local_views(abstract, pspecs, coords)
    else:
        params = M.local_views(abstract, expert_blocks(desc, axes, pspecs),
                               coords)

    if shape.kind == "train":
        opt_cfg = opt.AdamWConfig(total_steps=1000)
        batch = bundle.input_specs(shape)
        b_lay = batch_layouts(desc, batch)
        if gradcomp:
            n_pods = desc.sizes["pod"]
            ostate = opt.init(params, opt_cfg)
            # on the layout the rank's block of the residuals: its pod's row
            resid = init_residuals(params, 1 if on_layout else n_pods)
            # the rank's rows over "data": pod 0 takes its share of them
            rows = M.Sharding(desc, ("data",))
            local = {k: M.local_view(v, rows, {"data": 0})
                     for k, v in batch.items()}
            step = make_train_step_compressed(
                bundle, rmesh, opt_cfg, GradCompressionConfig(), donate=True)
            resid_lay = T.tree_map(
                lambda s: M.Sharding(desc, ("pod",) + s.spec), pspecs)
            layout = {"params": layout_bytes(abstract, pspecs),
                      "opt": 3 * layout_bytes(abstract, pspecs,
                                              torch.float32) + 4,
                      "resid": layout_bytes(T.tree_map(
                          lambda t: t.new_empty((n_pods,) + tuple(t.shape)),
                          abstract), resid_lay, torch.float32),
                      "batch": layout_bytes(batch, b_lay)}
            held = {"params": params, "opt": ostate, "resid": resid,
                    "batch": local}
            return (lambda: step((params, ostate, resid), local,
                                 rmesh.axis("pod")), held, layout)
        ostate = opt.init(params, opt_cfg)
        local = _rank0(batch, T.tree_map(data_only, b_lay))
        step = make_train_step(bundle, rmesh, opt_cfg, donate=True,
                               micro=MICROBATCHES.get(arch_name, 1))
        layout = {"params": layout_bytes(abstract, pspecs),
                  "opt": 3 * layout_bytes(abstract, pspecs,
                                          torch.float32) + 4,
                  "batch": layout_bytes(batch, b_lay)}
        held = {"params": params, "opt": ostate, "batch": local}
        return lambda: step((params, ostate), local), held, layout

    if shape.kind == "prefill":
        batch = bundle.input_specs(shape)
        b_lay = batch_layouts(desc, batch)
        local = M.local_views(batch, T.tree_map(data_only, b_lay), coords)
        layout = {"params": layout_bytes(abstract, pspecs),
                  "batch": layout_bytes(batch, b_lay)}
        held = {"params": params, "batch": local}
        return lambda: bundle.prefill(params, local, rmesh), held, layout

    ins = bundle.input_specs(shape, quantized_kv=variant == "kvq")
    c_lay = M.cache_layouts(desc, ins["cache"], shape.global_batch)
    t_lay = M.greedy_sharding(desc, ins["tokens"].shape)
    cache = M.local_views(ins["cache"], c_lay if on_layout else T.tree_map(
        data_only, c_lay), coords)
    # the layout's step takes the rank's block with the cache's global size
    given = (RankCache(cache, shape.global_batch, shape.seq_len)
             if on_layout else cache)
    tokens = M.local_view(ins["tokens"], data_only(t_lay), coords)
    kv_cfg = kv_quantizer_config() if variant == "kvq" else None
    pos = shape.seq_len - 1           # a host int, as the step reads it
    layout = {"params": layout_bytes(abstract, pspecs),
              "cache": layout_bytes(ins["cache"], c_lay),
              "batch": layout_bytes(ins["tokens"], t_lay) + 4}
    held = {"params": params, "cache": cache, "batch": tokens}
    return (lambda: bundle.serve_step(params, given, tokens, pos, rmesh,
                                      kv_cfg), held, layout)


# ------------------------------------------------------------- records --

def _reset_launches() -> None:
    for m in cost.kernel_modules():
        m.reset_launches()


def launches_by_b(counts: dict, per: int = 1) -> dict:
    """Launch counts {wrapper counter: n} as {B-number: n / per}, the
    kernels that ran only."""
    return {B_NUMBERS[k]: n / per if per > 1 else n
            for k, n in counts.items() if n}


def stop_site(exc: BaseException) -> dict:
    """Where a cell stopped: the port's innermost frame (file:line and its
    source line) and the op the error names (`aten::...`, a host sync)."""
    where = line = None
    for fs in traceback.extract_tb(exc.__traceback__):
        p = Path(fs.filename).resolve()
        if PORT_ROOT in p.parents and p.name != "cost.py":
            where = f"{p.relative_to(PORT_ROOT.parent)}:{fs.lineno}"
            line = (fs.line or "").strip()
    msg = str(exc)
    m = re.search(r"aten::[\w.]+", msg)
    if m:
        op = m.group(0)
    elif "item()" in msg or ".item" in msg:
        op = "Tensor.item"
    elif isinstance(exc, cost.TraceBudgetExceeded):
        op = "trace budget"
    else:
        op = line
    return {"op": op, "where": where, "source": line}


def hbm_capacity(hbm_bytes=None):
    """The card's memory where a card is present, else `hbm_bytes`."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return None if hbm_bytes is None else int(hbm_bytes)


def measure(fn, held: dict, recorder, budget_s=None) -> tuple:
    """Run fn() under `cost.counting` with the held trees' bytes as the
    base; returns (its output, the Count, launches by B-number)."""
    base = cost.tree_bytes(held, lambda t: cost.granule_bytes(
        t.numel() * t.element_size()))
    _reset_launches()
    with cost.counting(base, recorder, budget_s=budget_s) as c:
        out = fn()
    return out, c, launches_by_b(cost.launch_counts())


def cell_tag(arch: str, shape: str, mesh_kind: str, variant: str) -> str:
    return f"{mesh_kind}.{arch}.{shape}" + (
        "" if variant == "baseline" else f".{variant}")


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             variant: str = "baseline", force: bool = False,
             hbm_bytes=None, budget_s=None, results_dir=None) -> dict:
    """One cell on one mesh: its JSON record (cached under results_dir,
    default RESULTS_DIR, unless force)."""
    out_dir = Path(results_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / (cell_tag(arch_name, shape_name, mesh_kind,
                                   variant) + ".json")
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    desc = M.make_production_mesh(multi_pod=mesh_kind == "multi")
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "status": "error",
           "n_devices": desc.size}
    t0 = time.time()
    try:
        recorder = cost.Recorder()
        with torch.device("meta"):
            fn, held, layout = cell_program(arch_name, shape_name, desc,
                                            variant, recorder)
            out, c, launches = measure(fn, held, recorder, budget_s)
        held_by = {k: cost.tree_bytes(v) for k, v in held.items()}
        cap = hbm_capacity(hbm_bytes)
        rec.update(
            status="ok",
            held_bytes=sum(held_by.values()), held_by=held_by,
            layout_bytes=sum(layout.values()), layout_by=layout,
            out_bytes=cost.tree_bytes(out), peak_bytes=c.peak_bytes,
            flops=c.flops, collective_bytes=c.collective_bytes,
            launches=launches, hbm_bytes=cap,
            fits=None if cap is None else c.peak_bytes <= cap)
    except Exception as e:   # noqa: BLE001 - a stopped cell is recorded loudly
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec.update(stop_site(e))
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["run_s"] = round(time.time() - t0, 2)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def variants_of(variant: str, shape_name: str, mesh_kind: str) -> tuple:
    """The variants a cell runs under `--variant`: one, or for "all" the
    baseline and the variant its kind has (kvq for decode, gradcomp for
    train on the multi-pod mesh)."""
    if variant != "all":
        return (variant,)
    kind = SHAPES[shape_name].kind
    if kind == "decode":
        return ("baseline", "kvq")
    if kind == "train" and mesh_kind == "multi":
        return ("baseline", "gradcomp")
    return ("baseline",)


def _run_one(args) -> dict:
    torch.set_num_threads(1)
    return run_cell(*args[:4], **args[4])


def summary_line(rec: dict) -> str:
    head = (f"{rec['mesh']:6s} {rec['arch']:26s} {rec['shape']:12s} "
            f"{rec['variant']:8s}")
    if rec["status"] != "ok":
        return f"[ERR] {head} {rec.get('where')} {rec['error'][:120]}"
    gib = 2.0 ** 30
    groups = "".join(
        f" {k}={rec['held_by'][k] / gib:.3f}/{rec['layout_by'][k] / gib:.3f}"
        for k in ("params", "cache") if k in rec["held_by"])
    return (f"[OK ] {head} held={rec['held_bytes'] / gib:8.2f}GiB "
            f"layout={rec['layout_bytes'] / gib:7.2f}GiB "
            f"peak={rec['peak_bytes'] / gib:8.2f}GiB "
            f"flops={rec['flops']:.3e} run={rec['run_s']:.1f}s"
            f" (held/layout GiB:{groups})")


def _cell_text(rec, what: str, hbm_bytes=None) -> str:
    if rec is None:
        return "—"
    if rec["status"] != "ok":
        return "stopped"
    gib = 2.0 ** 30
    if what == "flops":
        return f"{rec['flops'] / 1e12:.4g}"
    if what == "coll":
        return f"{sum(rec['collective_bytes'].values()) / 1e9:.4g}"
    if what == "fits":
        cap = rec.get("hbm_bytes") or hbm_bytes
        return "—" if cap is None else (
            "yes" if rec["peak_bytes"] <= cap else "no")
    return f"{rec[what] / gib:.4g}"


def table(results_dir=None, hbm_bytes=None) -> str:
    """A markdown table of the cached records: a row per cell, each
    number for the single; multi mesh, bytes in GiB (collectives GB),
    FLOPs in TFLOP; the variant's peak and launches; `fits` against each
    record's card memory or `hbm_bytes`; stopped cells with the op and
    the port's file:line."""
    d = Path(results_dir or RESULTS_DIR)
    recs = {}
    for f in d.glob("*.json"):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"], r["mesh"], r["variant"])] = r
    head = ("| cell | held GiB | layout GiB | peak GiB | TFLOP | "
            "collective GB | kvq / gradcomp: peak GiB, launches | "
            "fits |\n|---|---|---|---|---|---|---|---|")
    rows, stops = [head], []
    for arch, shape in all_cells():
        get = lambda mk, v="baseline": recs.get((arch, shape, mk, v))
        cols = ["; ".join(_cell_text(get(mk), w, hbm_bytes)
                          for mk in ("single", "multi"))
                for w in ("held_bytes", "layout_bytes", "peak_bytes",
                          "flops", "coll", "fits")]
        var = []
        for mk in ("single", "multi"):
            for v in ("kvq", "gradcomp"):
                r = get(mk, v)
                if r is not None and r["status"] == "ok":
                    launch = ", ".join(f"{k} {n}" for k, n in
                                       sorted(r["launches"].items()))
                    var.append(f"{mk[0]} {v} {_cell_text(r, 'peak_bytes')}"
                               f"{', ' + launch if launch else ''}")
                elif r is not None:
                    var.append(f"{mk[0]} {v} stopped")
        rows.append(f"| {arch} {shape} | " + " | ".join(cols[:5])
                    + f" | {'; '.join(var) or '—'} | {cols[5]} |")
        for r in recs.values():
            if (r["arch"], r["shape"]) == (arch, shape) and \
                    r["status"] != "ok":
                stops.append(f"{r['mesh']} {arch} {shape} {r['variant']}: "
                             f"{r.get('op')} at {r.get('where')}")
    return "\n".join(rows + [""] + sorted(stops))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", help="an arch, or several, comma-separated")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--variant", choices=VARIANTS + ("all",),
                    default="baseline",
                    help="all: baseline on every cell, kvq on the decode "
                         "cells, gradcomp on the train cells (multi mesh)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the cached records as a markdown table")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="a card's memory for `fits` where no card is "
                         "present")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="stop a cell whose program runs longer (seconds)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in this many processes at once")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch:
        archs = args.arch.split(",")
        cells = [c for c in cells if c[0] in archs]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.list:
        for c in cells:
            print(*c)
        return 0
    if args.table:
        print(table(args.results_dir, args.hbm_bytes))
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    kw = dict(force=args.force, hbm_bytes=args.hbm_bytes,
              budget_s=args.budget_s, results_dir=args.results_dir)
    jobs = [(arch, shape, mk, v, kw) for arch, shape in cells
            for mk in meshes for v in variants_of(args.variant, shape, mk)]
    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs) as ex:
            recs = list(ex.map(_run_one, jobs))
    else:
        recs = [_run_one(j) for j in jobs]
    n_ok = sum(r["status"] == "ok" for r in recs)
    for r in recs:
        print(summary_line(r), flush=True)
    print(f"\n{n_ok} ok, {len(recs) - n_ok} failed")
    return 1 if n_ok < len(recs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
