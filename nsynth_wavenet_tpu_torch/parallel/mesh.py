"""The device mesh over torch.distributed (counterpart of
nsynth_wavenet_tpu/parallel/mesh.py).

One process per device.  The ranks 0 .. n-1 of a mesh are laid out as a
(data, model[, seq]) array, as JAX lays out its devices, and every axis has
one process group per line of ranks along it (``dist.new_group``):

  * ``data``: batch rows.  A rank owns the rows ``rows`` gives it; the
    training steps average the gradient over the data group before the clip
    and Adam, and reduce their metrics over it.
  * ``model``: channel tensor parallelism (Megatron's pair): the dilated and
    mel_cond convs are column-parallel (their gate-width output axis is
    sharded), the res and skip 1x1s row-parallel (their gate-half input
    axis), every other leaf is whole on every rank.  The gate takes
    sigmoid(d[..., :m]) * tanh(d[..., m:]), so a contiguous shard of the gate
    width would give the first ranks only sigmoid columns: each half is
    sharded on its own, rank r holding sigmoid columns [r m/n, (r+1) m/n) and
    the matching tanh columns (``split_leaf``), and ``gather_params`` puts
    the reference's layout back.
  * ``seq``: time chunks of one-shot student serving
    (models/parallelgen.py synthesize_seq_sharded).

Without an initialised process group a mesh has one rank and no groups, and
every collective here is the identity.  Collectives on CUDA tensors over a
gloo group (two ranks sharing one card) go through host memory, since gloo
reduces and broadcasts CUDA tensors but gathers and sends only host ones.
"""

import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


# ---- process group -------------------------------------------------------------


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def init_distributed(device=None, backend: Optional[str] = None) -> torch.device:
    """Join the process group that torch's ``env://`` variables describe
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK, as torchrun sets
    them) and return this rank's device: cuda:LOCAL_RANK unless ``device``
    names the CPU (or another device).  The backend follows the device (nccl
    for CUDA, gloo for the CPU) unless ``backend`` names one.  A failure
    raises; nothing falls back to another backend or device."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None or torch.device(device).type == "cuda":
        dev = torch.device(device) if device is not None else torch.device("cuda")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a CUDA device; pass device='cpu' for the CPU")
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend=backend, init_method="env://", **kw)
    return dev


def barrier():
    """Wait for every process of the group (nothing without one)."""
    if initialized():
        dist.barrier()


def shutdown():
    """Leave the process group (and forget the meshes built on it)."""
    _MESHES.clear()
    if initialized():
        dist.destroy_process_group()


# ---- mesh shapes ---------------------------------------------------------------


def mesh_shape(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
               world: Optional[int] = None) -> dict:
    """{'data': n_data, 'model': n_model[, 'seq': n_seq]} over ``world`` ranks
    (default: the process group's); n_data defaults to every rank left over,
    as make_mesh in the JAX package does."""
    world = process_count() if world is None else world
    if n_data is None:
        n_data = world // (n_model * n_seq)
    need = n_data * n_model * n_seq
    if n_data < 1 or need > world:
        raise ValueError(f"a ({n_data}, {n_model}, {n_seq}) mesh needs {need} ranks, have {world}")
    shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    if n_seq > 1:
        shape[SEQ_AXIS] = n_seq
    return shape


def batch_mesh_shape(batch_size: int, n_model: int = 1, n_seq: int = 1,
                     world: Optional[int] = None) -> dict:
    """mesh_shape whose data axis takes the largest count that divides the
    batch and fits the ranks left after the model and seq axes."""
    world = process_count() if world is None else world
    avail = world // (n_model * n_seq)
    if avail < 1:
        raise ValueError(f"need n_model*n_seq={n_model * n_seq} ranks, have {world}")
    n = avail
    while n > 1 and batch_size % n != 0:
        n -= 1
    return mesh_shape(n, n_model, n_seq, world)


class Mesh:
    """This rank's place in a mesh: ``shape`` (axis -> size), ``coords``
    (axis -> index; None on a rank past the mesh, which ``member`` tells) and
    one process group per axis (None without a process group)."""

    def __init__(self, shape: dict, rank: int = 0, groups: Optional[dict] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        dims = tuple(self.shape.values())
        self.member = rank < int(np.prod(dims))
        self.coords = (dict(zip(self.axis_names, (int(c) for c in np.unravel_index(rank, dims))))
                       if self.member else None)
        self.groups = groups or {}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in the {self.shape} mesh")
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def tp_group(self):
        """The model group when the model axis is sharded, else None."""
        return self.group(MODEL_AXIS) if self.size(MODEL_AXIS) > 1 else None

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


# the meshes built on the process group, by shape: building one calls
# dist.new_group on every rank (collective), so a shape is built once
_MESHES = {}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1) -> Mesh:
    """The (data, model[, seq]) mesh over the process group's ranks, one
    group per line of every axis.  Every rank must call it, in the same order
    (``dist.new_group`` is collective); a mesh of one shape is built once."""
    return _build(mesh_shape(n_data, n_model, n_seq))


def mesh_for_batch(batch_size: int, n_model: int = 1, n_seq: int = 1) -> Mesh:
    """The mesh the train CLIs' --n_model / --n_seq build: the data axis
    takes the largest count that divides the batch (batch_mesh_shape)."""
    return _build(batch_mesh_shape(batch_size, n_model, n_seq))


def _build(shape: dict) -> Mesh:
    key = tuple(shape.items())
    if key in _MESHES:
        return _MESHES[key]
    rank, groups = process_index(), {}
    if initialized():
        dims = tuple(shape.values())
        ranks = np.arange(int(np.prod(dims))).reshape(dims)
        for i, axis in enumerate(shape):
            for line in np.moveaxis(ranks, i, -1).reshape(-1, dims[i]):
                members = [int(r) for r in line]
                g = dist.new_group(members)
                if rank in members:
                    groups[axis] = g
    mesh = Mesh(shape, rank, groups)
    _MESHES[key] = mesh
    return mesh


def rows(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch that this rank's data index owns."""
    n = mesh.size(DATA_AXIS)
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not divide over {n} data ranks")
    b = batch_size // n
    i = mesh.index(DATA_AXIS)
    return slice(i * b, (i + 1) * b)


class RowDraws:
    """A generator whose draws are made for the global batch (``draw``):
    [total, *shape[1:]] is drawn and rows [start, start + shape[0]) are
    returned, so that N ranks draw what one process draws at that batch."""

    def __init__(self, generator: torch.Generator, start: int, total: int):
        self.generator, self.start, self.total = generator, start, total


def draw(fn, generator, shape, device=None) -> torch.Tensor:
    """fn(shape, generator=generator) (torch.rand or torch.randn) on
    ``device`` (default the generator's), or this rank's rows of the global
    batch's draw when generator is a RowDraws."""
    shape = tuple(shape)
    if isinstance(generator, RowDraws):
        g = generator.generator
        full = fn((generator.total,) + shape[1:], generator=g, device=device or g.device)
        return full[generator.start : generator.start + shape[0]]
    return fn(shape, generator=generator, device=device or generator.device)


def uniform(generator, shape, device) -> torch.Tensor:
    """torch.rand(shape) on ``device`` from ``generator`` (see draw)."""
    return draw(torch.rand, generator, shape, device)


# ---- collectives ---------------------------------------------------------------


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of t over ``group`` (a new tensor; t when group is None)."""
    if group is None:
        return t
    h = t.detach().to("cpu" if _via_host(t, group) else t.device)
    h = h.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(h, op=op, group=group)
    return h.to(t.device)


def all_gather(t: torch.Tensor, group) -> list:
    """[t of every rank of ``group``] in group-rank order."""
    if group is None:
        return [t]
    src = t.detach().contiguous()
    if _via_host(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def broadcast(t: torch.Tensor) -> torch.Tensor:
    """Process 0's t on every process (a new tensor; t itself without a
    process group)."""
    if not initialized():
        return t
    h = t.detach().to("cpu" if _via_host(t, dist.group.WORLD) else t.device)
    h = h.clone(memory_format=torch.contiguous_format)
    dist.broadcast(h, src=0)
    return h.to(t.device)


def replicate_tree(tree):
    """Every leaf of ``tree`` broadcast from process 0, so that the replicas
    start equal (cuDNN need not give two processes the same bits, e.g. in
    the data-dependent init's upsampler)."""
    from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

    return tree_lib.tree_map(broadcast, tree)


def send_right_recv_left(t: torch.Tensor, group, recv_like: torch.Tensor):
    """Send t to the next rank of ``group`` and receive recv_like's shape
    from the previous one (None on the first rank; the last rank sends
    nothing)."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    host = _via_host(t, group)
    ops = []
    buf = None
    if r + 1 < n:
        src = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, src.cpu() if host else src,
                              dist.get_global_rank(group, r + 1), group))
    if r > 0:
        buf = torch.empty_like(recv_like, device="cpu" if host else recv_like.device)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, r - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if buf is None else buf.to(recv_like.device)


# ---- tensor-parallel autograd functions (Megatron's pair) ----------------------


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel product, whole on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """Sum over the group forward (the partial outputs of a row-parallel
    product); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumPartials(torch.autograd.Function):
    """Sum over the group forward and backward: a quantity summed from every
    rank's shard whose consumers are again per-shard (the squared norm of a
    row-parallel kernel's output channel), so each rank's gradient of the sum
    is a partial one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to_region(x, group):
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x, group):
    return x if group is None else _ReduceFromRegion.apply(x, group)


def sum_partials(x, group):
    return x if group is None else _SumPartials.apply(x, group)


# ---- tensor-parallel layout of WaveNet parameter trees ---------------------------
#
# The rules of the JAX package, on the port's key paths (tree.leaf_paths):
# column-parallel dilated / mel_cond kernels shard axis 2 and their biases and
# gains axis 0; row-parallel res / skip kernels shard axis 1.  Everything else
# (starts, heads, deconv) is whole on every rank.  They hold for the teacher
# and for every flow of the student, and for the Adam moments of either.

_COLUMN = re.compile(r"\['layers'\]\[\d+\]\['(dilated|mel_cond)'\]")
_ROW = re.compile(r"\['layers'\]\[\d+\]\['(res|skip)'\]")
_LEAF = re.compile(r"\['([^']*)'\]$")


def wavenet_tp_spec(path: str) -> Optional[int]:
    """The sharded axis of the leaf at ``path`` (None: whole on every rank);
    the axis JAX's wavenet_tp_spec names with 'model'."""
    m = _LEAF.search(path)
    leaf = m.group(1) if m else None
    if leaf in ("w", "v"):
        if _COLUMN.search(path):
            return 2
        if _ROW.search(path):
            return 1
    elif leaf in ("b", "g") and _COLUMN.search(path):
        return 0
    return None


def gate_sharded(path: str) -> bool:
    """Whether the leaf's sharded axis is a gate width (its two halves are
    sharded on their own)."""
    return bool(_COLUMN.search(path))


def split_leaf(x: torch.Tensor, axis: int, n: int, gate: bool) -> list:
    """x cut into n shards along ``axis``; with ``gate`` each half of the
    axis is cut on its own and shard r holds the r-th piece of both."""
    if gate:
        halves = torch.chunk(x, 2, dim=axis)
        if halves[0].shape[axis] % n:
            raise ValueError(f"gate half {halves[0].shape[axis]} does not divide over {n} ranks")
        a, b = torch.chunk(halves[0], n, dim=axis), torch.chunk(halves[1], n, dim=axis)
        return [torch.cat([a[r], b[r]], dim=axis).contiguous() for r in range(n)]
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not divide over {n} ranks")
    return [c.contiguous() for c in torch.chunk(x, n, dim=axis)]


def join_leaf(parts: list, axis: int, gate: bool) -> torch.Tensor:
    """The inverse of split_leaf."""
    if gate:
        halves = [torch.chunk(p, 2, dim=axis) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=axis)
    return torch.cat(parts, dim=axis)


def _leaf_axis(path, leaf, spec_fn):
    axis = spec_fn(path)
    if axis is None or not hasattr(leaf, "ndim") or leaf.ndim <= axis:
        return None
    return axis


def shard_tree(tree, n: int, r: int, spec_fn=wavenet_tp_spec, prefix: str = ""):
    """Shard r of n of every leaf that spec_fn shards (the others as they are)."""
    from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

    def one(path, leaf):
        axis = _leaf_axis(path, leaf, spec_fn)
        return leaf if axis is None else split_leaf(leaf, axis, n, gate_sharded(path))[r]

    return tree_lib.map_with_path(one, tree, prefix)


def sharded_norm(params, mesh: Optional[Mesh], spec_fn=wavenet_tp_spec):
    """(flags, group) for the optimizer's clip (training/optimizer.py) when
    the model axis of ``mesh`` is sharded, else None: flags marks, in leaves
    order, the leaves of ``params`` that shard_params shards."""
    from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

    if mesh is None or mesh.tp_group() is None:
        return None
    flags = [_leaf_axis(path, leaf, spec_fn) is not None
             for path, leaf in zip(tree_lib.leaf_paths(params), tree_lib.leaves(params))]
    return flags, mesh.tp_group()


def shard_params(params, mesh: Mesh, spec_fn=wavenet_tp_spec, prefix: str = ""):
    """This rank's shard of a parameter tree over the model axis."""
    n = mesh.size(MODEL_AXIS)
    return params if n == 1 else shard_tree(params, n, mesh.index(MODEL_AXIS), spec_fn, prefix)


def gather_params(params, mesh: Mesh, spec_fn=wavenet_tp_spec, prefix: str = ""):
    """The whole tree in the reference's layout from every model rank's
    shard (collective over the model group)."""
    from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

    group = mesh.tp_group()
    if group is None:
        return params

    def one(path, leaf):
        axis = _leaf_axis(path, leaf, spec_fn)
        if axis is None:
            return leaf
        return join_leaf(all_gather(leaf, group), axis, gate_sharded(path))

    return tree_lib.map_with_path(one, params, prefix)


def _moment_prefixes(params, labels):
    """The key path of every leaf that holds Adam moments when the moments
    are a flat list (MultiTransform: the 'train' leaves in leaves order)."""
    from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

    paths = tree_lib.leaf_paths(params)
    if labels is None:
        return paths
    return [p for p, label in zip(paths, labels) if label == "train"]


def _map_state(state, labels, fn):
    """fn(tree, prefix) over the params, the EMA and the Adam moments of a
    train state; moments kept as a flat list go leaf by leaf, each under its
    param's path."""
    out = dict(state)
    out["params"] = fn(state["params"], "")
    out["ema"] = fn(state["ema"], "")
    opt = dict(state["opt_state"])
    for k in ("mu", "nu"):
        if isinstance(opt[k], dict):
            opt[k] = fn(opt[k], "")
        else:
            paths = _moment_prefixes(state["params"], labels)
            opt[k] = [fn(t, p) for t, p in zip(opt[k], paths)]
    out["opt_state"] = opt
    return out


def shard_train_state(state, mesh: Mesh, labels=None, spec_fn=wavenet_tp_spec):
    """This rank's shard of a train state {params, opt_state, ema, step}:
    the rules match the params', the EMA's and the Adam moments' paths alike;
    every other leaf stays whole.  labels: MultiTransform's 'train' /
    'freeze' per leaf when the moments are a flat list of the trained leaves."""
    if mesh.size(MODEL_AXIS) == 1:
        return state
    return _map_state(state, labels, lambda t, p: shard_params(t, mesh, spec_fn, p))


def gather_train_state(state, mesh: Mesh, labels=None, spec_fn=wavenet_tp_spec):
    """The inverse of shard_train_state (collective over the model group)."""
    if mesh.size(MODEL_AXIS) == 1:
        return state
    return _map_state(state, labels, lambda t, p: gather_params(t, mesh, spec_fn, p))
