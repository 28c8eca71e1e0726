"""The teacher's training step (counterpart of
nsynth_wavenet_tpu/training/train_lib.py):

    wav crop -> mel on the device -> forward (dropout) -> loss -> autograd
    -> Adam (optional clip) -> EMA

State: {'params', 'opt_state', 'ema', 'step'}, the params and EMA in the
reference's pytree layout (f32 master weights whatever the compute dtype).
The step updates the state's tensors in place and returns the state.
"""

import torch

from nsynth_wavenet_tpu_torch.models.wavenet import no_tf32
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
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
    """The dropout masks' generator of one step, seeded from (seed, step), so
    that a resumed run draws the masks an uninterrupted one would."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def loss_and_grads(model, params, wav, mel, generator=None):
    """(loss, grads): the scalar loss tensor and the gradient of every leaf,
    shaped as params (zeros for a leaf the loss does not reach: the last
    layer's residual product)."""
    flat = tree_lib.leaves(params)
    req = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = model.forward_loss(tree_lib.unflatten(params, req), wav, mel, generator)["loss"]
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), tree_lib.unflatten(params, grads)


def make_wavenet_train_step(model, optimizer: opt_lib.Optimizer):
    """step_fn(state, wav, seed=None) -> (state, metrics).

    wav: [B, wave_length] float audio on the training device; the mel is
    computed there.  seed: the dropout seed (the runner passes seed + 2); None
    or a config without dropout draws no masks.  metrics: {'loss': 0-d
    tensor, 'learning_rate': the schedule at the step before the update}."""
    lr_fn = opt_lib.piecewise_constant_lr(model.cfg.lr_schedule)
    use_dropout = model.cfg.dropout_inputs or model.cfg.dropout_all

    def step_fn(state, wav, seed=None):
        step = state["step"]
        generator = None
        if use_dropout and seed is not None:
            generator = dropout_generator(seed, step, wav.device)
        with no_tf32():
            mel = stft_ops.melspectrogram(wav)
            loss, grads = loss_and_grads(model, state["params"], wav, mel, generator)
            state["opt_state"] = optimizer.update(grads, state["opt_state"], state["params"])
            opt_lib.ema_update(state["ema"], state["params"], step)
        state["step"] = step + 1
        return state, {"loss": loss, "learning_rate": float(lr_fn(step))}

    return step_fn


def make_cond_gap_fn(model):
    """Teacher-forced loss with another utterance's mel (the batch rolled by
    one) minus the loss with the matched mel; near zero means the model
    ignores its conditioning.  Needs B > 1."""

    @torch.no_grad()
    def gap_fn(params, wav):
        with no_tf32():
            mel = stft_ops.melspectrogram(wav)
            matched = model.forward_loss(params, wav, mel)["loss"]
            mismatched = model.forward_loss(params, wav, torch.roll(mel, 1, dims=0))["loss"]
        return float(mismatched - matched)

    return gap_fn


def run_data_dep_init(model, params, wav, mel, generator=None):
    """The data-dependent init pass: (out_params, rescaled params)."""
    ff, new_params = model.data_dep_init(params, wav, mel, generator=generator)
    return ff["out_params"], new_params
