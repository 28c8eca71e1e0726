"""The port's device mesh (parallel/mesh.py) against the JAX package's
(nsynth_wavenet_tpu/parallel/mesh.py), in one process: the mesh shapes
make_mesh / mesh_for_batch give for the same counts, the tensor-parallel
spec of every leaf of the golden teacher and student (and of their train
states' Adam moments), the gate-half sharding and its inverse bit for bit,
and the whole-batch draws a rank slices.  The collectives run in
tests/test_torch_multiprocess.py, test_torch_tensor_parallel.py and
test_torch_sharded_serving.py."""

import os

import jax
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.parallel import mesh as jmesh
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.parallel import mesh as tmesh
from nsynth_wavenet_tpu_torch.training import train_lib
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HEADS = ("tiny_ce", "tiny_mol", "tiny_gauss", "tiny_student")


@pytest.mark.parametrize("world,n_model,n_seq", [(8, 1, 1), (8, 2, 1), (8, 4, 1), (8, 1, 2),
                                                 (8, 2, 2), (6, 3, 1), (4, 1, 4)])
def test_make_mesh_shape_equals_jax(world, n_model, n_seq):
    devices = jax.devices()[:world]
    want = dict(jmesh.make_mesh(n_model=n_model, n_seq=n_seq, devices=devices).shape)
    assert tmesh.mesh_shape(n_model=n_model, n_seq=n_seq, world=world) == want
    assert list(tmesh.mesh_shape(n_model=n_model, n_seq=n_seq, world=world)) == \
        list(jmesh.make_mesh(n_model=n_model, n_seq=n_seq, devices=devices).axis_names)


@pytest.mark.parametrize("batch", (1, 2, 3, 4, 6, 8, 12, 16))
@pytest.mark.parametrize("world,n_model,n_seq", [(8, 1, 1), (8, 2, 1), (8, 1, 2), (6, 1, 1)])
def test_mesh_for_batch_shape_equals_jax(batch, world, n_model, n_seq):
    devices = jax.devices()[:world]
    want = dict(jmesh.mesh_for_batch(batch, n_model=n_model, n_seq=n_seq, devices=devices).shape)
    assert tmesh.batch_mesh_shape(batch, n_model, n_seq, world=world) == want
    if n_model == n_seq == 1:
        assert want == dict(jmesh.data_mesh_for_batch(batch, devices=devices).shape)


def test_mesh_refuses_too_few_ranks():
    with pytest.raises(ValueError, match="ranks"):
        tmesh.mesh_shape(n_model=4, world=2)
    with pytest.raises(ValueError, match="ranks"):
        tmesh.batch_mesh_shape(4, n_model=2, n_seq=2, world=2)


def join_trees(trees: list, prefix: str = ""):
    """The whole tree from the shard trees of every rank, in rank order (what
    mesh.gather_params gathers over a model group)."""
    flat = [tree_lib.leaves(t) for t in trees]
    out = []
    for i, path in enumerate(tree_lib.leaf_paths(trees[0], prefix)):
        axis = tmesh._leaf_axis(path, flat[0][i], tmesh.wavenet_tp_spec)
        out.append(flat[0][i] if axis is None
                   else tmesh.join_leaf([f[i] for f in flat], axis, tmesh.gate_sharded(path)))
    return tree_lib.unflatten(trees[0], out)


def _golden(name):
    return weights.load_npz(os.path.join(GOLDEN, name, "params.npz"), device="cpu")


def _jax_axis(spec):
    return None if spec == jmesh.P() else list(spec).index(jmesh.MODEL_AXIS)


@pytest.mark.parametrize("name", HEADS)
def test_tp_spec_equals_jax_on_every_golden_leaf(name):
    params = _golden(name)
    jtree = weights.to_jax_params(params)
    sharded = 0
    paths = tree_lib.leaf_paths(params)
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == paths
    for (jpath, _), path in zip(jleaves, paths):
        want = _jax_axis(jmesh.wavenet_tp_spec(jpath))
        assert tmesh.wavenet_tp_spec(path) == want, path
        sharded += want is not None
    assert sharded > 0
    # a train state's moments under the same paths: JAX's rules match them
    # alike (shard_train_state), and the port's by the params' paths
    state = {"opt_state": {"mu": jtree}}
    for jpath, _ in jax.tree_util.tree_flatten_with_path(state)[0]:
        path = jax.tree_util.keystr(jpath)
        assert tmesh.wavenet_tp_spec(path) == _jax_axis(jmesh.wavenet_tp_spec(jpath)), path


@pytest.mark.parametrize("name", HEADS)
@pytest.mark.parametrize("n", (2, 4))
def test_gather_of_shards_is_the_tree_bit_for_bit(name, n):
    params = _golden(name)
    shards = [tmesh.shard_tree(params, n, r) for r in range(n)]
    back = join_trees(shards)
    for k, v in weights.flatten(params).items():
        assert torch.equal(weights.flatten(back)[k], v), k
    # a shard's dilated kernel holds the matched sigmoid and tanh columns
    layers = params["layers"] if "layers" in params else params["flows"][0]["layers"]
    v = layers[0]["dilated"]["v" if "v" in layers[0]["dilated"] else "w"]
    m = v.shape[2] // 2
    for r, shard in enumerate(shards):
        sl = shard["layers"] if "layers" in shard else shard["flows"][0]["layers"]
        got = sl[0]["dilated"]["v" if "v" in layers[0]["dilated"] else "w"]
        c = m // n
        assert got.shape[2] == 2 * c
        assert torch.equal(got[..., :c], v[..., r * c : (r + 1) * c])
        assert torch.equal(got[..., c:], v[..., m + r * c : m + (r + 1) * c])
        # the res kernel's input rows are the gate outputs of those columns
        res = sl[0]["res"]["v" if "v" in sl[0]["res"] else "w"]
        full = layers[0]["res"]["v" if "v" in layers[0]["res"] else "w"]
        assert torch.equal(res, full[:, r * c : (r + 1) * c])


def test_train_state_shards_and_gathers_with_flat_moments():
    """A student's MultiTransform keeps moments only for its trained leaves,
    as a flat list: they shard by their params' paths."""
    cfg = tconfig.ParallelWavenetConfig(num_iaf_layers=(2, 2), num_stages=2, width=8,
                                        deconv_width=16, use_teacher_deconv=True,
                                        use_weight_norm=True)
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet

    params = ParallelWavenet(cfg).init_params(0, device="cpu")
    opt = train_lib.make_student_optimizer(cfg, params)
    state = train_lib.make_train_state(params, opt)
    labels = tree_lib.leaves(train_lib.student_param_labels(cfg, params))
    assert len(state["opt_state"]["mu"]) < len(labels)
    for i, t in enumerate(state["opt_state"]["mu"]):
        t.add_(float(i))
    shards = [tmesh._map_state(state, labels,
                               lambda tree, p: tmesh.shard_tree(tree, 2, r, prefix=p))
              for r in range(2)]
    mu0 = shards[0]["opt_state"]["mu"]
    trained = [p for p, lab in zip(tree_lib.leaf_paths(params), labels) if lab == "train"]
    for t, full, path in zip(mu0, state["opt_state"]["mu"], trained):
        axis = tmesh.wavenet_tp_spec(path)
        assert t.shape[axis if axis is not None else 0] == (
            full.shape[axis] // 2 if axis is not None else full.shape[0]), path
    for k in ("mu", "nu"):
        back = [join_trees([s["opt_state"][k][i] for s in shards], prefix=p)
                for i, p in enumerate(trained)]
        assert all(torch.equal(a, b) for a, b in zip(back, state["opt_state"][k]))


def test_row_draws_are_the_whole_batch_rows():
    for fn in (torch.rand, torch.randn):
        whole = fn((6, 5, 3), generator=torch.Generator().manual_seed(4))
        for start in (0, 2, 4):
            g = tmesh.RowDraws(torch.Generator().manual_seed(4), start, 6)
            assert torch.equal(tmesh.draw(fn, g, (2, 5, 3)), whole[start : start + 2])
    mesh = tmesh.Mesh({"data": 4, "model": 1}, rank=3)
    assert tmesh.rows(mesh, 8) == slice(6, 8)
    with pytest.raises(ValueError, match="divide"):
        tmesh.rows(mesh, 6)
    assert not tmesh.Mesh({"data": 2, "model": 1}, rank=3).member


def test_sharded_norm_flags_the_sharded_leaves():
    """The optimizer's clip sums the squares of the leaves flagged over the
    model group: flags as wavenet_tp_spec shards the leaves, the student's
    over its trained leaves only; none without a sharded model axis."""
    cfg = tconfig.ParallelWavenetConfig(num_iaf_layers=(2, 2), num_stages=2, width=8,
                                        deconv_width=16, use_teacher_deconv=True,
                                        use_weight_norm=True)
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet

    params = ParallelWavenet(cfg).init_params(0, device="cpu")
    group = object()  # stands for the model group: nothing here reduces over it
    mesh = tmesh.Mesh({"data": 1, "model": 2}, rank=0, groups={"model": group})
    flags, got = tmesh.sharded_norm(params, mesh)
    want = [tmesh.wavenet_tp_spec(p) is not None for p in tree_lib.leaf_paths(params)]
    assert got is group and flags == want and any(want)
    labels = tree_lib.leaves(train_lib.student_param_labels(cfg, params))
    opt = train_lib.make_student_optimizer(cfg, params, mesh)
    assert opt.sharded == ([f for f, lab in zip(want, labels) if lab == "train"], group)
    assert tmesh.sharded_norm(params, tmesh.Mesh({"data": 2, "model": 1})) is None
    assert train_lib.make_student_optimizer(cfg, params).sharded is None
