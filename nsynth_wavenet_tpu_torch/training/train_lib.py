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
(mesh.shard_train_state).  Its random draws are made for the global batch
and sliced (mesh.RowDraws), its gradient is averaged over the data group
before the clip and Adam (and the clip's norm summed over the model group),
and its metrics are reduced over the data group, so that N ranks compute
what one process computes at that batch.
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
    return {k: v.detach() for k, v in aux.items()}, tree_lib.unflatten(params, grads)


def loss_and_grads(model, params, wav, mel, generator=None, model_group=None):
    """The teacher's (loss, grads); the last layer's residual product gets a
    zero gradient (the loss does not reach it)."""
    aux, grads = grads_of(lambda p: model.forward_loss(p, wav, mel, generator, model_group),
                          params)
    return aux["loss"], grads


class _MeshStep:
    """What a step does on a mesh: its data group (the gradient average,
    the metrics), its model group (the sharded forward, the clip's norm) and
    this rank's rows of the global batch.  No mesh: one process."""

    def __init__(self, mesh, optimizer):
        self.mesh = mesh
        self.data_group = mesh.group(mesh_lib.DATA_AXIS) if mesh is not None else None
        self.n_data = mesh.size(mesh_lib.DATA_AXIS) if mesh is not None else 1
        self.model_group = mesh.tp_group() if mesh is not None else None
        if (optimizer is not None and self.model_group is not None
                and getattr(optimizer, "sharded", None) is None):
            raise ValueError("a step over a sharded model axis needs an optimizer built with "
                             "the mesh's sharded leaves (mesh.sharded_norm), or its clip reads "
                             "one shard's norm")

    def generator(self, seed, step, local_rows, device):
        g = dropout_generator(seed, step, device)
        if self.mesh is None:
            return g
        return mesh_lib.RowDraws(g, self.mesh.index(mesh_lib.DATA_AXIS) * local_rows,
                                 local_rows * self.n_data)

    def rows(self, local_rows) -> slice:
        if self.mesh is None:
            return slice(0, local_rows)
        return mesh_lib.rows(self.mesh, local_rows * self.n_data)

    def mean(self, x):
        """The mean of a per-rank mean over the data group."""
        if self.data_group is None:
            return x
        return mesh_lib.all_reduce(x, self.data_group) / self.n_data

    def mean_grads(self, grads):
        """The gradient averaged over the data group (one flat all-reduce)."""
        if self.data_group is None:
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
        if self.data_group is None:
            return x.std(unbiased=False)
        m = self.mean(x.mean())
        return torch.sqrt(self.mean(((x - m) ** 2).mean()))


def make_wavenet_train_step(model, optimizer: opt_lib.Optimizer, mesh=None):
    """step_fn(state, wav, seed=None) -> (state, metrics).

    wav: [B, wave_length] float audio on the training device (this rank's
    rows of the global batch over a mesh); the mel is computed there.  seed:
    the dropout seed (the runner passes seed + 2); None or a config without
    dropout draws no masks.  metrics: {'loss': 0-d tensor (the global
    batch's), 'learning_rate': the schedule at the step before the update}."""
    lr_fn = opt_lib.piecewise_constant_lr(model.cfg.lr_schedule)
    use_dropout = model.cfg.dropout_inputs or model.cfg.dropout_all
    ms = _MeshStep(mesh, optimizer)

    def step_fn(state, wav, seed=None):
        step = state["step"]
        generator = None
        if use_dropout and seed is not None:
            generator = ms.generator(seed, step, wav.shape[0], wav.device)
        with no_tf32():
            mel = stft_ops.melspectrogram(wav)
            loss, grads = loss_and_grads(model, state["params"], wav, mel, generator,
                                         ms.model_group)
            loss, grads = ms.mean(loss), ms.mean_grads(grads)
            state["opt_state"] = optimizer.update(grads, state["opt_state"], state["params"])
            opt_lib.ema_update(state["ema"], state["params"], step)
        state["step"] = step + 1
        return state, {"loss": loss, "learning_rate": float(lr_fn(step))}

    return step_fn


def make_cond_gap_fn(model, mesh=None):
    """Teacher-forced loss with another utterance's mel (the batch rolled by
    one) minus the loss with the matched mel; near zero means the model
    ignores its conditioning.  Needs B > 1.  Over a mesh every rank gathers
    the global batch from its data group and scores it whole (collective)."""
    ms = _MeshStep(mesh, None)

    @torch.no_grad()
    def gap_fn(params, wav):
        if ms.data_group is not None:
            wav = torch.cat(mesh_lib.all_gather(wav, ms.data_group))
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


STD_METRICS = ("new_x_std", "new_x_abs_std")


def student_loss(pwn, teacher_params, params, batch, draws, norm_stats=None, model_group=None,
                 std=None):
    """The distillation loss dict of params on batch {'mel', 'wav'
    (+ 'mel_rand')} with ``draws`` (student_draws), and the reference's
    statistics of the sample: new_x, new_x_std, new_x_abs, new_x_abs_std,
    mean_tot, scale_tot, log_scale_tot.  model_group: the student's and the
    teacher's params are sharded over it; std: the standard deviation taken
    for STD_METRICS (the global batch's over a mesh)."""
    std = std or (lambda t: t.std(unbiased=False))
    ff, _ = pwn.feed_forward_train(params, {"mel": batch["mel"], "base_x": draws["base_x"]},
                                   model_group=model_group)
    ff.update(batch)
    loss_dict = pwn.calculate_loss(teacher_params, ff, draws, norm_stats, model_group)
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
    rank's rows of the global batch over a mesh; teacher_params then sharded
    as the state is); wav_rand feeds the contrastive term's mismatched mel
    (unused without it).  The draws come from dropout_generator(seed, step)
    for the global batch (the runner passes seed + 2) unless ``draws`` gives
    them (student_draws' keys, the global batch's); this rank takes its
    rows.  metrics: the global batch's loss dict as 0-d tensors and
    'learning_rate', the schedule at the step before the update."""
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
            draws = {k: v[rows] for k, v in draws.items()}
            metrics, grads = grads_of(
                lambda p: student_loss(pwn, teacher_params, p, batch, draws, norm_stats,
                                       ms.model_group, ms.std),
                state["params"])
            grads = ms.mean_grads(grads)
            metrics = {k: v if k in STD_METRICS else ms.mean(v) for k, v in metrics.items()}
            state["opt_state"] = optimizer.update(grads, state["opt_state"], state["params"])
            opt_lib.ema_update(state["ema"], state["params"], step)
        state["step"] = step + 1
        metrics["learning_rate"] = float(lr_fn(step))
        return state, metrics

    return step_fn

