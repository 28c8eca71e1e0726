"""The training steps (counterpart of
nsynth_wavenet_tpu/training/train_lib.py).

Teacher:  wav crop -> mel on the device -> forward (dropout) -> loss ->
          autograd -> Adam (optional clip) -> EMA
Student:  wav crops -> mels -> base noise -> IAF flows -> frozen teacher's
          scoring -> KL (+ power, contrastive) -> autograd -> Adam on the
          trained leaves -> EMA over every leaf

State: {'params', 'opt_state', 'ema', 'step'}, the params and EMA in the
reference's pytree layout (f32 master weights whatever the compute dtype).
A step updates the state's tensors in place and returns the state.

Over a device mesh (parallel/mesh.py) a step takes this rank's rows of the
global batch and, with a sharded model axis, this rank's shard of the state
(mesh.shard_train_state).  With a seq axis it is handed the rows' whole
crops, computes their mels whole, and runs the models on its time chunk
(mesh.seq_chunk), the causal convs exchanging halos with the neighbours.
Its random draws are made for the global batch and sliced to its rows and
chunk (mesh.RowDraws), its gradient is averaged over the data x seq group
before the clip and Adam (and the clip's norm summed over the model group),
and its metrics are reduced over that group, so that N ranks compute what
one process computes at that batch.
"""

import torch

from nsynth_wavenet_tpu_torch.models.wavenet import no_tf32
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.training import optimizer as opt_lib
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib


def make_train_state(params, optimizer: opt_lib.Optimizer):
    params = tree_lib.tree_map(lambda p: p.detach().to(torch.float32).clone(), params)
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "ema": tree_lib.tree_map(torch.clone, params),  # the shadow starts at the initial value
        "step": 0,
    }


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """A step's generator (the teacher's dropout masks, the student's noise),
    seeded from (seed, step), so that a resumed run draws what an
    uninterrupted one would."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def grads_of(loss_fn, params):
    """(aux, grads): loss_fn(params) -> a dict holding the scalar 'loss';
    aux is that dict detached, grads the gradient of every leaf shaped as
    params (zeros for a leaf the loss does not reach)."""
    flat = tree_lib.leaves(params)
    req = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        aux = loss_fn(tree_lib.unflatten(params, req))
        grads = torch.autograd.grad(aux["loss"], req, allow_unused=True)
    # contiguous, as the params and the Adam moments are: a strided gradient
    # (the deconv's) would send every torch._foreach_* op of the update down
    # its per-tensor path
    grads = [torch.zeros_like(p) if g is None else g.contiguous() for p, g in zip(flat, grads)]
    aux = {k: v if isinstance(v, dict) else v.detach() for k, v in aux.items()}
    return aux, tree_lib.unflatten(params, grads)


def loss_and_grads(model, params, wav, mel, generator=None, model_group=None, seq_group=None):
    """The teacher's (loss, grads); the last layer's residual product gets a
    zero gradient (the loss does not reach it).  seq_group: this rank's
    chunk's loss and its part of the gradient."""
    aux, grads = grads_of(lambda p: model.forward_loss(p, wav, mel, generator, model_group,
                                                       seq_group), params)
    return aux["loss"], grads


class _MeshStep:
    """What a step does on a mesh: its replica group (data x seq: the
    gradient average, the metrics, the histograms), its model group (the
    sharded forward, the clip's norm), its seq group (the halo exchanges)
    and this rank's rows and time chunk of the global batch.  No mesh: one
    process."""

    def __init__(self, mesh, optimizer):
        self.mesh = mesh
        self.group = mesh.replica_group() if mesh is not None else None
        self.n_rep = mesh.replicas() if mesh is not None else 1
        self.n_data = mesh.size(mesh_lib.DATA_AXIS) if mesh is not None else 1
        self.model_group = mesh.tp_group() if mesh is not None else None
        self.seq_group = mesh.seq_group() if mesh is not None else None
        if (optimizer is not None and self.model_group is not None
                and getattr(optimizer, "sharded", None) is None):
            raise ValueError("a step over a sharded model axis needs an optimizer built with "
                             "the mesh's sharded leaves (mesh.sharded_norm), or its clip reads "
                             "one shard's norm")

    def generator(self, seed, step, local_rows, length, device):
        """The step's generator; over a mesh, a RowDraws of this rank's rows
        and (with a seq axis) its chunk of a length-``length`` time axis."""
        g = dropout_generator(seed, step, device)
        if self.mesh is None:
            return g
        time = None
        if self.seq_group is not None:
            time = (self.chunk(length).start, length)
        return mesh_lib.RowDraws(g, self.mesh.index(mesh_lib.DATA_AXIS) * local_rows,
                                 local_rows * self.n_data, time)

    def rows(self, local_rows) -> slice:
        if self.mesh is None:
            return slice(0, local_rows)
        return mesh_lib.rows(self.mesh, local_rows * self.n_data)

    def chunk(self, length) -> slice:
        return mesh_lib.seq_chunk(length, self.seq_group)

    def mean(self, x):
        """The mean of a per-rank mean over the replica group."""
        if self.group is None:
            return x
        return mesh_lib.all_reduce(x, self.group) / self.n_rep

    def mean_grads(self, grads):
        """The gradient averaged over the replica group (one flat all-reduce)."""
        if self.group is None:
            return grads
        flat = tree_lib.leaves(grads)
        buf = self.mean(torch.cat([g.reshape(-1) for g in flat]))
        out, k = [], 0
        for g in flat:
            out.append(buf[k : k + g.numel()].view_as(g))
            k += g.numel()
        return tree_lib.unflatten(grads, out)

    def std(self, x):
        """The population standard deviation of x over the global batch."""
        if self.group is None:
            return x.std(unbiased=False)
        m = self.mean(x.mean())
        return torch.sqrt(self.mean(((x - m) ** 2).mean()))

    def metrics(self, aux):
        """The global batch's metrics from this rank's: the histograms and the
        std metrics are the global batch's already, the rest are averaged
        over the replica group."""
        return {k: v if isinstance(v, dict) or k in STD_METRICS else self.mean(v)
                for k, v in aux.items()}


def make_wavenet_train_step(model, optimizer: opt_lib.Optimizer, mesh=None):
    """step_fn(state, wav, seed=None) -> (state, metrics).

    wav: [B, wave_length] float audio on the training device (this rank's
    rows of the global batch over a mesh, whole crops; a rank of a seq axis
    runs on its chunk of them); the mel is computed there.  seed: the
    dropout seed (the runner passes seed + 2); None or a config without
    dropout draws no masks.  metrics: {'loss': 0-d tensor (the global
    batch's), 'learning_rate': the schedule at the step before the update},
    and the DETAIL_LOG histograms (the global tensors') under cfg.detail_log."""
    lr_fn = opt_lib.piecewise_constant_lr(model.cfg.lr_schedule)
    use_dropout = model.cfg.dropout_inputs or model.cfg.dropout_all
    ms = _MeshStep(mesh, optimizer)

    def step_fn(state, wav, seed=None):
        step = state["step"]
        generator = None
        if use_dropout and seed is not None:
            generator = ms.generator(seed, step, wav.shape[0], wav.shape[1], wav.device)
        with no_tf32():
            mel = stft_ops.melspectrogram(wav)
            aux, grads = grads_of(
                lambda p: model.forward_loss(p, wav, mel, generator, ms.model_group, ms.seq_group,
                                             ms.group), state["params"])
            metrics, grads = ms.metrics(aux), ms.mean_grads(grads)
            state["opt_state"] = optimizer.update(grads, state["opt_state"], state["params"])
            opt_lib.ema_update(state["ema"], state["params"], step)
        state["step"] = step + 1
        metrics["learning_rate"] = float(lr_fn(step))
        return state, metrics

    return step_fn


def wavenet_halo_exchanges(cfg, input_grad: bool = False) -> dict:
    """The halo exchanges (mesh.halo_exchanges) of one teacher forward and
    backward on a seq axis: forward one for the shift, and one for the
    start conv and each dilated layer when filter_length > 1; backward one
    for each dilated layer, and for the shift and the start conv when the
    input needs a gradient (the student's sample under the frozen teacher;
    never the data)."""
    convs = cfg.num_layers + 1 if cfg.filter_length > 1 else 0
    return {"forward": 1 + convs,
            "backward": 1 + convs if input_grad else max(convs - 1, 0)}


def make_cond_gap_fn(model, mesh=None):
    """Teacher-forced loss with another utterance's mel (the batch rolled by
    one) minus the loss with the matched mel; near zero means the model
    ignores its conditioning.  Needs B > 1.  Over a mesh every rank gathers
    the global batch from its data group (the ranks of its model and seq
    index) and scores the whole crops (collective over the model group)."""
    ms = _MeshStep(mesh, None)
    data_group = mesh.group(mesh_lib.DATA_AXIS) if mesh is not None else None

    @torch.no_grad()
    def gap_fn(params, wav):
        if data_group is not None:
            wav = torch.cat(mesh_lib.all_gather(wav, data_group))
        with no_tf32():
            mel = stft_ops.melspectrogram(wav)
            matched = model.forward_loss(params, wav, mel, model_group=ms.model_group)["loss"]
            mismatched = model.forward_loss(params, wav, torch.roll(mel, 1, dims=0),
                                            model_group=ms.model_group)["loss"]
        return float(mismatched - matched)

    return gap_fn


def run_data_dep_init(model, params, wav, mel, generator=None):
    """The data-dependent init pass: (out_params, rescaled params)."""
    ff, new_params = model.data_dep_init(params, wav, mel, generator=generator)
    return ff["out_params"], new_params


# ---- the student ---------------------------------------------------------------


def student_param_labels(pwn_cfg, params):
    """'train' / 'freeze' for every leaf, shaped as params: with
    use_teacher_deconv the shared deconv stack stays at the teacher's
    weights."""
    labels = tree_lib.tree_map(lambda _: "train", params)
    if pwn_cfg.use_teacher_deconv and "deconv_share" in params:
        labels["deconv_share"] = tree_lib.tree_map(lambda _: "freeze", params["deconv_share"])
    return labels


def make_student_optimizer(pwn_cfg, params, mesh=None) -> opt_lib.MultiTransform:
    """mesh: the params are sharded over its model axis (the clip's norm
    then sums the trained shards' squares over the model group)."""
    labels = student_param_labels(pwn_cfg, params)
    sharded = mesh_lib.sharded_norm(params, mesh)
    if sharded is not None:
        flags, group = sharded
        sharded = ([f for f, label in zip(flags, tree_lib.leaves(labels)) if label == "train"],
                   group)
    inner = opt_lib.make_optimizer(pwn_cfg.lr_schedule, grad_clip=pwn_cfg.grad_clip,
                                   sharded=sharded)
    return opt_lib.MultiTransform(inner, labels)


def student_draws(pwn, generator, batch_size: int, length: int, device) -> dict:
    """A step's random draws in the reference's order: the base noise
    'base_x' [B, L], then the KL's and the contrastive term's logistic
    samples (ParallelWavenet.loss_noise)."""
    draws = {"base_x": pwn.base_noise(generator, batch_size, length, device)}
    draws.update(pwn.loss_noise(generator, batch_size, length, device))
    return draws


def pwn_halo_exchanges(pwn) -> dict:
    """The halo exchanges of one distillation step on a seq axis: each
    flow's shift, start conv and dilated layers (the first flow's shift and
    start conv read the noise, which needs no gradient), and one pass of the
    frozen teacher's trunk on the student's sample, forward and backward
    (the KL and the contrastive term score it in one 2B batch; with
    remat_teacher the recompute reads the forward's halos)."""
    cfg = pwn.cfg
    fwd = bwd = 0
    for fi, n in enumerate(cfg.num_iaf_layers):
        convs = n + 1 if cfg.filter_length > 1 else 0
        fwd += 1 + convs
        bwd += 1 + convs if fi > 0 else max(convs - 1, 0)
    te = wavenet_halo_exchanges(pwn.teacher.cfg, input_grad=True)
    return {"forward": fwd + te["forward"], "backward": bwd + te["backward"]}


STD_METRICS = ("new_x_std", "new_x_abs_std")


def student_loss(pwn, teacher_params, params, batch, draws, norm_stats=None, model_group=None,
                 std=None, seq_group=None, hist_group=None):
    """The distillation loss dict of params on batch {'mel', 'wav'
    (+ 'mel_rand')} with ``draws`` (student_draws), and the reference's
    statistics of the sample: new_x, new_x_std, new_x_abs, new_x_abs_std,
    mean_tot, scale_tot, log_scale_tot (+ the DETAIL_LOG per-flow scalars
    and histograms).  model_group: the student's and the teacher's params
    are sharded over it; std: the standard deviation taken for STD_METRICS
    (the global batch's over a mesh); seq_group: the draws are this rank's
    chunk (the mels and wav whole); hist_group: the histograms' group."""
    std = std or (lambda t: t.std(unbiased=False))
    ff, _ = pwn.feed_forward_train(params, {"mel": batch["mel"], "base_x": draws["base_x"]},
                                   model_group=model_group, seq_group=seq_group,
                                   hist_group=hist_group)
    ff.update(batch)
    loss_dict = pwn.calculate_loss(teacher_params, ff, draws, norm_stats, model_group, seq_group)
    loss_dict.update(ff.get("detail", {}))
    x = ff["x"].detach()
    loss_dict.update(
        new_x=x.mean(), new_x_std=std(x), new_x_abs=x.abs().mean(),
        new_x_abs_std=std(x.abs()), mean_tot=ff["mean_tot"].detach().mean(),
        scale_tot=ff["scale_tot"].detach().mean(),
        log_scale_tot=ff["log_scale_tot"].detach().mean())
    return loss_dict


def make_pwn_train_step(pwn, teacher_params, optimizer, norm_stats=None, mesh=None):
    """step_fn(state, wav, wav_rand, seed, draws=None) -> (state, metrics).

    wav, wav_rand: [B, wave_length] float audio on the training device (this
    rank's rows of the global batch over a mesh, whole crops; teacher_params
    then sharded as the state is); wav_rand feeds the contrastive term's
    mismatched mel (unused without it).  The draws come from
    dropout_generator(seed, step) for the global batch (the runner passes
    seed + 2) unless ``draws`` gives them (student_draws' keys, the global
    batch's); this rank takes its rows and, on a seq axis, its chunk of the
    sample length.  metrics: the global batch's loss dict as 0-d tensors
    (and histograms under cfg.detail_log) and 'learning_rate', the schedule
    at the step before the update."""
    lr_fn = opt_lib.piecewise_constant_lr(pwn.cfg.lr_schedule)
    use_cl = pwn.cfg.loss_type == "logistic" and pwn.cfg.contrastive_loss_factor > 0.0
    ms = _MeshStep(mesh, optimizer)

    def step_fn(state, wav, wav_rand, seed, draws=None):
        step = state["step"]
        rows = ms.rows(wav.shape[0])
        with no_tf32():
            batch = {"mel": stft_ops.melspectrogram(wav), "wav": wav}
            if use_cl:
                batch["mel_rand"] = stft_ops.melspectrogram(wav_rand)
            if draws is None:
                draws = student_draws(pwn, dropout_generator(seed, step, wav.device),
                                      wav.shape[0] * ms.n_data,
                                      pwn.sample_length(batch["mel"].shape[1]), wav.device)
            chunk = ms.chunk(pwn.sample_length(batch["mel"].shape[1]))
            draws = {k: v[rows][..., chunk] for k, v in draws.items()}
            aux, grads = grads_of(
                lambda p: student_loss(pwn, teacher_params, p, batch, draws, norm_stats,
                                       ms.model_group, ms.std, ms.seq_group, ms.group),
                state["params"])
            metrics, grads = ms.metrics(aux), ms.mean_grads(grads)
            state["opt_state"] = optimizer.update(grads, state["opt_state"], state["params"])
            opt_lib.ema_update(state["ema"], state["params"], step)
        state["step"] = step + 1
        metrics["learning_rate"] = float(lr_fn(step))
        return state, metrics

    return step_fn

