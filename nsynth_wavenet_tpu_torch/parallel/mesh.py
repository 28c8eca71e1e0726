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
  * ``seq``: time chunks.  Rank r of a seq line owns samples
    [r L/n, (r+1) L/n) of its data index's rows (``seq_chunk``): in training
    only the trunks' activations of that chunk live on it, and every causal
    conv reads the steps before its chunk from its left neighbours through a
    halo exchange (``halo``); in one-shot student serving
    (models/parallelgen.py synthesize_seq_sharded) each flow reads its
    receptive field.  The gradient and the metrics of a training step are
    averaged over the data x seq ranks that share a model index
    (``Mesh.replica_group``).

Without an initialised process group a mesh has one rank and no groups, and
every collective here is the identity.  Collectives on CUDA tensors over a
gloo group (two ranks sharing one card) go through host memory, since gloo
reduces and broadcasts CUDA tensors but gathers and sends only host ones.
"""

import contextlib
import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
# the key of the data x seq group in Mesh.groups
REPLICA_AXES = (DATA_AXIS, SEQ_AXIS)


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

    def seq_group(self):
        """The seq group when the seq axis is sharded, else None."""
        return self.group(SEQ_AXIS) if self.size(SEQ_AXIS) > 1 else None

    def replica_group(self):
        """The ranks that hold the same model shard: data x seq of this
        rank's model index (the data group without a seq axis)."""
        return self.groups.get(REPLICA_AXES)

    def replicas(self) -> int:
        return self.size(DATA_AXIS) * self.size(SEQ_AXIS)

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
        if SEQ_AXIS in shape:
            # data x seq of every model index (ranks[d, m, s], seq fastest)
            for m in range(dims[1]):
                members = [int(r) for r in ranks[:, m, :].reshape(-1)]
                g = dist.new_group(members)
                if rank in members:
                    groups[REPLICA_AXES] = g
        elif DATA_AXIS in groups:
            groups[REPLICA_AXES] = groups[DATA_AXIS]
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


def seq_position(group) -> tuple:
    """(index, size) of this rank in a seq group ((0, 1) for None)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _chunk(length: int, r: int, n: int) -> slice:
    if length % n:
        raise ValueError(f"a sequence of {length} samples does not divide over {n} seq ranks; "
                         f"use a length that is a multiple of {n}")
    c = length // n
    return slice(r * c, (r + 1) * c)


def seq_chunk(length: int, mesh) -> slice:
    """The samples [r L/n, (r+1) L/n) of a length-L sequence that this rank
    owns on the seq axis of ``mesh`` (a Mesh, a seq group or None: the whole
    sequence).  A length that n does not divide is refused (the JAX package
    pads it instead)."""
    if isinstance(mesh, Mesh):
        r, n = mesh.index(SEQ_AXIS), mesh.size(SEQ_AXIS)
    else:
        r, n = seq_position(mesh)
    return _chunk(length, r, n)


class RowDraws:
    """A generator whose draws are made for the global batch (``draw``):
    [total, *shape[1:]] is drawn and rows [start, start + shape[0]) are
    returned, so that N ranks draw what one process draws at that batch.
    time=(t0, length): the draws' axis 1 is time, drawn at ``length`` and
    cut to [t0, t0 + shape[1]) (this rank's chunk on the seq axis)."""

    def __init__(self, generator: torch.Generator, start: int, total: int, time=None):
        self.generator, self.start, self.total, self.time = generator, start, total, time


def draw(fn, generator, shape, device=None) -> torch.Tensor:
    """fn(shape, generator=generator) (torch.rand or torch.randn) on
    ``device`` (default the generator's), or this rank's rows (and time
    chunk) of the global batch's draw when generator is a RowDraws."""
    shape = tuple(shape)
    if isinstance(generator, RowDraws):
        g = generator.generator
        lead = (generator.total,)
        if generator.time is not None:
            lead += (generator.time[1],)
        full = fn(lead + shape[len(lead):], generator=g, device=device or g.device)
        full = full[generator.start : generator.start + shape[0]]
        if generator.time is not None:
            t0 = generator.time[0]
            full = full[:, t0 : t0 + shape[1]]
        return full
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
    dev = "cpu" if _via_host(t, group) else t.device
    sends = [(t.detach().contiguous().to(dev), r + 1)] if r + 1 < n else []
    buf = torch.empty_like(recv_like, device=dev) if r > 0 else None
    _p2p(sends, [] if buf is None else [(buf, r - 1)], group)
    return None if buf is None else buf.to(recv_like.device)


def _p2p(sends, recvs, group):
    """Post every (tensor, group rank) send and receive at once and wait."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, q), group) for t, q in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, q), group) for t, q in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


# ---- sequence parallelism: halo exchanges ----------------------------------------

# exchanges made since the last reset, by direction: one ``halo`` call is
# one forward exchange, and one backward exchange when its input needs a
# gradient; a halo replayed from a tape (checkpoint recompute) is not counted
halo_exchanges = {"forward": 0, "backward": 0}


def reset_halo_counts():
    halo_exchanges["forward"] = halo_exchanges["backward"] = 0


def _halo_peers(r: int, n: int, T: int, H: int, right: bool) -> list:
    """The pieces of an exchange of H steps before each chunk of T: with
    right=False those rank r receives, [(source, lo, hi)], else those it
    sends, [(dest, lo, hi)]; lo, hi are global positions (the source owns
    [s T, (s+1) T)).  A halo longer than a chunk spans several ranks."""
    out = []
    peers = range(r + 1, n) if right else range(r - 1, -1, -1)
    for q in peers:
        s, dst = (r, q) if right else (q, r)
        lo, hi = max(dst * T - H, s * T), (s + 1) * T
        if lo >= hi:
            break
        out.append((q, lo, hi))
    return out


class HaloTape:
    """Received halos kept in the order they came, for a checkpointed
    region: ``record`` keeps every halo its forward receives, ``replay``
    hands them out again in the recompute of the backward pass instead of
    exchanging again (torch.utils.checkpoint's context_fn)."""

    active = None  # (mode, tape) of the innermost context

    def __init__(self):
        self.halos, self.pos = [], 0

    @contextlib.contextmanager
    def _mode(self, mode):
        saved, HaloTape.active = HaloTape.active, (mode, self)
        try:
            yield
        finally:
            HaloTape.active = saved

    def record(self):
        return self._mode("record")

    def replay(self):
        self.pos = 0
        return self._mode("replay")


def halo_checkpoint_contexts():
    """context_fn for torch.utils.checkpoint (use_reentrant=False) around a
    region that exchanges halos: the recompute reads the forward's halos."""
    tape = HaloTape()
    return tape.record(), tape.replay()


def _receive_halo(x, H, group):
    r, n = seq_position(group)
    B, T, C = x.shape
    host = _via_host(x, group)
    buf_dev = "cpu" if host else x.device
    halo = torch.zeros((B, H, C), dtype=x.dtype, device=buf_dev)
    base = r * T - H  # the global position of halo row 0
    sends = [(x[:, lo - r * T : hi - r * T].contiguous().to(buf_dev), q)
             for q, lo, hi in _halo_peers(r, n, T, H, right=True)]
    recvs = [(halo[:, lo - base : hi - base], q) for q, lo, hi in _halo_peers(r, n, T, H, False)]
    # receive into contiguous buffers (a row slice of [B, H, C] is not one)
    bufs = [(torch.empty_like(v, memory_format=torch.contiguous_format), q) for v, q in recvs]
    _p2p(sends, bufs, group)
    for (v, _), (b, _) in zip(recvs, bufs):
        v.copy_(b)
    return halo.to(x.device)


class _Halo(torch.autograd.Function):
    """[B, T, C] chunk -> [B, H + T, C]: the H steps before the chunk (its
    left neighbours' last rows, zeros before the sequence's start) in front.
    The backward sends the halo's gradient back to the ranks it came from,
    which add it into their last rows."""

    @staticmethod
    def forward(ctx, x, H, group):
        ctx.H, ctx.group = H, group
        tape = HaloTape.active
        if tape is not None and tape[0] == "replay":
            t = tape[1]
            halo, t.pos = t.halos[t.pos], t.pos + 1
        else:
            halo = _receive_halo(x, H, group)
            halo_exchanges["forward"] += 1
            if tape is not None:
                tape[1].halos.append(halo)
        return torch.cat([halo, x], dim=1)

    @staticmethod
    def backward(ctx, g):
        H, group = ctx.H, ctx.group
        r, n = seq_position(group)
        T = g.shape[1] - H
        host = _via_host(g, group)
        buf_dev = "cpu" if host else g.device
        base = r * T - H
        dx = g[:, H:].contiguous()
        sends = [(g[:, lo - base : hi - base].contiguous().to(buf_dev), q)
                 for q, lo, hi in _halo_peers(r, n, T, H, right=False)]
        recvs = [(torch.empty((g.shape[0], hi - lo, g.shape[2]), dtype=g.dtype, device=buf_dev),
                  q, lo) for q, lo, hi in _halo_peers(r, n, T, H, right=True)]
        _p2p(sends, [(b, q) for b, q, _ in recvs], group)
        for b, _, lo in recvs:
            dx[:, lo - r * T : lo - r * T + b.shape[1]] += b.to(dx.device)
        halo_exchanges["backward"] += 1
        return dx, None, None


def halo(x: torch.Tensor, H: int, group) -> torch.Tensor:
    """x [B, T, C], this rank's chunk of a sequence sharded over the seq
    ``group``, with the H steps before it in front: [B, H + T, C].  H may
    exceed T (the halo then spans several left neighbours).  group None:
    zeros in front."""
    if group is None:
        return torch.nn.functional.pad(x, (0, 0, H, 0))
    return _Halo.apply(x, H, group)


class _SeqGather(torch.autograd.Function):
    """The whole sequence from every rank's chunk along ``dim``; the backward
    returns this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r, n = seq_position(ctx.group)
        return g.narrow(ctx.dim, r * (g.shape[ctx.dim] // n), g.shape[ctx.dim] // n), None, None


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The whole sequence from the chunks of the seq ``group`` (x when None)."""
    return x if group is None else _SeqGather.apply(x, group, dim)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def scale_grad(x: torch.Tensor, k: float) -> torch.Tensor:
    """x, whose gradient is multiplied by k."""
    return x if k == 1 else _ScaleGrad.apply(x, k)


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
