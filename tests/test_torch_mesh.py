"""The port's mesh layer (`repro_torch.launch.mesh`), the abstract
parameter and input trees (`models.params.abstract`/`axes_tree`,
`ModelBundle.abstract_params`/`axes`/`input_specs`) and the elastic
resize (`runtime.elastic`) against the JAX package's.

The reference's `logical_to_spec` reads only `mesh.axis_names` and
`mesh.devices.shape`, so it is given a stand-in with a numpy array of the
production mesh's shape (no 512 host devices are forced).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs import base as JB
from repro.configs import registry as JR
from repro.launch import mesh as JM
from repro.models import build as j_build
from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.launch import mesh as TM
from repro_torch.models import build as t_build
from repro_torch.runtime import elastic

ARCH_NAMES = sorted(JR.ARCHS)
MULTI = [False, True]


@dataclasses.dataclass
class _MeshShape:
    """What the reference's logical_to_spec reads of a mesh."""
    axis_names: tuple
    devices: np.ndarray


def _ref_mesh(multi_pod: bool) -> _MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _MeshShape(names, np.zeros(shape))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _axes_leaves(tree) -> list:
    """The axes tuples of a dict tree, keys sorted (jax's leaf order)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    return [tree]


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple)
                           and not hasattr(x, "_fields"))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_params_and_axes_equal_the_reference(name):
    """For every arch (full size; the hybrid's specs too): every leaf's
    shape, dtype and logical axes equal the reference's, in the
    reference's leaf order; the meta tensors hold no storage."""
    jb, tb = j_build(JR.get(name)), t_build(TR.get(name))
    j_abs = jax.tree.leaves(jb.abstract_params())
    t_abs, _ = T.flatten(tb.abstract_params())
    assert [tuple(a.shape) for a in j_abs] == [tuple(t.shape) for t in t_abs]
    assert [str(a.dtype) for a in j_abs] == [_dtype_name(t.dtype)
                                             for t in t_abs]
    assert all(t.device.type == "meta" for t in t_abs)
    assert _ref_leaves(jb.axes()) == _axes_leaves(tb.axes())
    assert tb.n_params() == jb.n_params()


@pytest.mark.parametrize("multi_pod", MULTI)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_shardings_equal_the_reference(name, multi_pod):
    """Every leaf's spec from `param_shardings` (with the leaves' shapes:
    an axis that does not divide its dim is dropped) and without shapes
    equals the reference's `logical_to_spec`, entry for entry."""
    jmesh = _ref_mesh(multi_pod)
    tmesh = TM.make_production_mesh(multi_pod=multi_pod)
    assert tmesh.axis_names == jmesh.axis_names
    assert tmesh.shape == jmesh.devices.shape
    jb, tb = j_build(JR.get(name)), t_build(TR.get(name))
    j_pairs = zip(_ref_leaves(jb.axes()),
                  jax.tree.leaves(jb.abstract_params()))
    want_shaped = [tuple(JM.logical_to_spec(ax, jmesh, ab.shape))
                   for ax, ab in j_pairs]
    want_plain = [tuple(JM.logical_to_spec(ax, jmesh))
                  for ax in _ref_leaves(jb.axes())]
    for shaped, want in ((True, want_shaped), (False, want_plain)):
        got = TM.param_shardings(tmesh, tb.axes(),
                                 tb.abstract_params() if shaped else None)
        got, _ = T.flatten(got)
        assert all(s.mesh is tmesh for s in got)
        assert [s.spec for s in got] == want, (name, shaped)


@pytest.mark.parametrize("multi_pod", MULTI)
@pytest.mark.parametrize("axes,shape", [
    (("vocab", "embed"), (51865, 512)),        # whisper's vocab, unpadded
    (("embed", "heads"), (512, 8)),            # 8 heads over 16 ranks
    (("embed", "heads"), (48, 64)),            # embed over 32 (multi-pod)
    ((None, "experts", "embed", None), (2, 64, 2048, 1024)),
    (("mlp", None), (4096, 16)), (("layers", "mlp"), (4, 100))])
def test_axes_that_do_not_divide_stay_replicated(axes, shape, multi_pod):
    """The rule that drops a mesh axis whose size does not divide the
    dim (no production arch's leaf meets it at full size): the reference's
    spec on each case."""
    want = tuple(JM.logical_to_spec(axes, _ref_mesh(multi_pod), shape))
    got = TM.logical_to_spec(axes, TM.make_production_mesh(
        multi_pod=multi_pod), shape)
    assert got == want


def _shape_pairs():
    return [(a, s) for a in ARCH_NAMES for s in sorted(JB.SHAPES)]


@pytest.mark.parametrize("name,shape", _shape_pairs())
def test_input_specs_equal_the_reference(name, shape):
    """Every input of every (arch, shape) cell: the same tree of shapes and
    dtypes as the reference's ShapeDtypeStructs, quantized and raw KV for
    the decode shapes, on the meta device (the hybrid's decode cache is
    raw either way, as the reference's)."""
    jb, tb = j_build(JR.get(name)), t_build(TR.get(name))
    jshape, tshape = JB.SHAPES[shape], TB.SHAPES[shape]
    for quantized in ((False, True) if jshape.kind == "decode" else (False,)):
        want = jb.input_specs(jshape, quantized_kv=quantized)
        got = tb.input_specs(tshape, quantized_kv=quantized)
        assert sorted(got) == sorted(want)
        j_leaves = jax.tree.leaves(want)
        t_leaves, _ = T.flatten(got)
        assert [(tuple(a.shape), str(a.dtype)) for a in j_leaves] == [
            (tuple(t.shape), _dtype_name(t.dtype)) for t in t_leaves]
        assert all(t.device.type == "meta" for t in t_leaves)


@pytest.mark.parametrize("multi_pod", MULTI)
def test_batch_cache_and_replicated_shardings_equal_the_reference(multi_pod):
    """`batch_sharding`, `batch_shardings_for`, `replicated`, `data_axes`
    and `cache_shardings` over the raw and quantized KV caches, whisper's
    two caches and xlstm's recurrent state, entry for entry."""
    jmesh = _ref_mesh(multi_pod)
    tmesh = TM.make_production_mesh(multi_pod=multi_pod)
    dp = JM.data_axes(jmesh)
    assert TM.data_axes(tmesh) == dp
    for nd in (1, 2, 3):
        assert TM.batch_sharding(tmesh, nd).spec == tuple(
            jax.sharding.PartitionSpec(dp, *(None,) * (nd - 1)))
    assert TM.replicated(tmesh).spec == tuple(jax.sharding.PartitionSpec())
    for name, quantized in (("internlm2-20b", False), ("internlm2-20b", True),
                            ("whisper-base", False), ("xlstm-350m", False)):
        jb, tb = j_build(JR.get(name).reduced()), t_build(
            TR.get(name).reduced())
        jc = jax.eval_shape(lambda: jb.make_cache(2, 256, quantized))
        tc = tb.make_cache(2, 256, quantized, device="meta")
        want = [tuple(jax.sharding.PartitionSpec(None, dp, *(None,) * (
            a.ndim - 2))) if a.ndim >= 2 else () for a in
                jax.tree.leaves(jc)]
        got, _ = T.flatten(TM.cache_shardings(tmesh, tc))
        assert [s.spec for s in got] == want, name
        got_b, _ = T.flatten(TM.batch_shardings_for(tmesh, tc))
        assert [s.spec for s in got_b] == [tuple(jax.sharding.PartitionSpec(
            dp, *(None,) * (a.ndim - 1))) for a in jax.tree.leaves(jc)]


@pytest.mark.parametrize("multi_pod", MULTI)
def test_hybrid_cache_shardings_take_dim_1(multi_pod):
    """`cache_shardings` over the hybrid's cache keeps the reference's rule:
    dim 1 over the data axes for every leaf of 2 or more dims.  For the
    attention K/V ([P, B, S, G, hd]) that is the batch; for the conv tails
    and SSM states ([P, n_mamba, B, ...]) it is the Mamba block axis, and
    the reference's docstring leaves their batch dim (2) to the caller.
    Pinned as the reference gives it."""
    tmesh = TM.make_production_mesh(multi_pod=multi_pod)
    dp = JM.data_axes(_ref_mesh(multi_pod))
    cfg = JR.get("jamba-1.5-large-398b").reduced()
    jc = jax.eval_shape(lambda: j_build(cfg).make_cache(2, 256))
    tc = t_build(TR.get("jamba-1.5-large-398b").reduced()).make_cache(
        2, 256, device="meta")
    want = [tuple(jax.sharding.PartitionSpec(None, dp, *(None,) * (
        a.ndim - 2))) for a in jax.tree.leaves(jc)]
    got, _ = T.flatten(TM.cache_shardings(tmesh, tc))
    assert [s.spec for s in got] == want
    assert [t.ndim for t in T.leaves(tc)] == [5, 5, 5, 5]
    assert got[2].spec[2] is None and got[3].spec[2] is None   # B: not
    assert tc[1][0].shape[1] == cfg.attn_period - 1      # n_mamba, not B


def test_local_views_tile_the_tensor_and_share_its_storage():
    """On a (2, 4) mesh every rank's block of an ('embed', 'experts')-
    sharded leaf is a view of it, and the blocks tile it in row-major
    rank order."""
    mesh = TM.Mesh((2, 4), ("data", "model"))
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    sh = TM.Sharding(mesh, ("data", "model"))
    blocks = [TM.local_view(t, sh, c) for c in TM.mesh_coords(mesh)]
    assert all(b.untyped_storage().data_ptr()
               == t.untyped_storage().data_ptr() for b in blocks)
    rows = [torch.cat(blocks[4 * d:4 * d + 4], 1) for d in range(2)]
    assert torch.equal(torch.cat(rows, 0), t)
    multi = TM.make_production_mesh(multi_pod=True)
    sh2 = TM.Sharding(multi, (("pod", "data"), None))
    t2 = torch.arange(64.0).reshape(32, 2)
    b = TM.local_view(t2, sh2, {"pod": 1, "data": 3, "model": 0})
    assert torch.equal(b, t2[19:20])                    # (1 * 16 + 3)
    tree = {"a": t, "b": (t2, t2[:4])}
    shs = {"a": sh, "b": (TM.replicated(mesh), TM.replicated(mesh))}
    out = TM.local_views(tree, shs, {"data": 1, "model": 2})
    assert torch.equal(out["a"], t[4:, 6:9]) and out["b"][0] is t2


def test_thread_mesh_axes_follow_the_coordinates():
    """run_mesh_threads((2, 3)): every rank's axes have the mesh's sizes,
    its coordinates, and psum over each axis sums its line only."""
    def rank(m):
        c = m.coords()
        v = torch.tensor([10.0 * c["data"] + c["model"]])
        return (c, m.axis("data").size, m.axis("model").size,
                float(m.axis("model").psum(v)), float(m.axis("data").psum(v)))

    got = TM.run_mesh_threads((2, 3), ("data", "model"), rank)
    for r, (c, nd, nm, over_model, over_data) in enumerate(got):
        assert c == {"data": r // 3, "model": r % 3} and (nd, nm) == (2, 3)
        assert over_model == 30.0 * c["data"] + 3
        assert over_data == 10.0 + 2 * c["model"]


def test_description_mesh_has_no_rank():
    with pytest.raises(ValueError, match="description"):
        TM.make_production_mesh().axis("model")


# ------------------------------------------------------------ elastic --

def test_elastic_resize_restores_bit_for_bit(tmp_path):
    """The reference's tests/test_runtime.py elastic case in the port: a
    checkpoint written with one layout restores onto `make_mesh_for`'s
    (1, 1) mesh over this process's CPU, every array and the step as
    saved; the port's checkpoint leaf files are the reference's bytes."""
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    state = {"w": torch.arange(64.0).reshape(8, 8),
             "b": torch.arange(8, dtype=torch.bfloat16)}
    mgr.save(3, state, blocking=True)
    mesh = elastic.make_mesh_for([torch.device("cpu")])
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")

    def rules(m):
        return {"w": TM.Sharding(m, ("data", None)),
                "b": TM.replicated(m)}

    restored, step, mesh2 = elastic.resize(
        mgr, T.tree_map(lambda t: torch.empty_like(t, device="meta"), state),
        rules, devices=[torch.device("cpu")])
    assert step == 3 and mesh2.shape == (1, 1) and len(restored) == 1
    for k in state:
        assert torch.equal(restored[0][k].view(torch.int16 if k == "b" else
                                               torch.int32),
                           state[k].view(torch.int16 if k == "b" else
                                         torch.int32))
    JCkpt(str(tmp_path / "ref"), keep=2).save(
        3, {"w": jnp.arange(64.0).reshape(8, 8)}, blocking=True)
    ref_leaf = next((tmp_path / "ref").glob("step-*/leaf-00000.npy"))
    port_leaf = next((tmp_path / "port").glob("step-*/leaf-00001.npy"))
    assert ref_leaf.read_bytes() == port_leaf.read_bytes()


def test_elastic_reshards_onto_a_larger_mesh():
    """make_mesh_for over 8 devices (CPU stand-ins) with model_parallel 3
    lowers it to 2 (the largest divisor); reshard_state gives each device
    its block under the rules."""
    devs = [torch.device("cpu")] * 8
    mesh = elastic.make_mesh_for(devs, model_parallel=3)
    assert mesh.shape == (4, 2)
    assert elastic.make_mesh_for(devs).shape == (1, 8)
    w = torch.arange(8.0 * 6).reshape(8, 6)
    out = elastic.reshard_state({"w": w}, lambda m: {
        "w": TM.Sharding(m, ("data", "model"))}, mesh)
    assert len(out) == 8
    assert torch.equal(out[3]["w"], w[2:4, 3:6])         # data 1, model 1
