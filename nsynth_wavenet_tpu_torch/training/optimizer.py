"""Piecewise-constant learning rate, Adam, the optional global-norm clip and
the EMA of the weights, with optax's semantics (counterpart of
nsynth_wavenet_tpu/training/optimizer.py, whose optax chain is
clip_by_global_norm(1.0) -> scale_by_adam(eps=1e-8) ->
scale_by_learning_rate):

  * the learning rate is read at the update count before the update;
  * Adam: m_hat / (sqrt(v_hat) + eps), eps outside the square root, bias
    corrections at the count after the update;
  * the clip divides every gradient by the global norm when it is not below
    1 (optax adds nothing to the norm; ``clip_grad_norm_`` adds 1e-6);
  * EMA decay min(0.9999, (1 + t) / (10 + t)) at the step before the
    increment, applied after the update, the shadow starting at the
    initial params.

The arithmetic runs in place over the flat leaf lists with
``torch._foreach_*`` ops, f32 scalars as optax computes them.  State:
{'count': int, 'mu': tree, 'nu': tree}.
"""

import numpy as np
import torch

from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

EMA_DECAY = 0.9999
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def piecewise_constant_lr(schedule):
    """((step, lr), ...) -> fn(step) -> np.float32 lr of the last boundary <= step."""
    pairs = sorted(schedule)
    boundaries = np.array([s for s, _ in pairs[1:]], np.int64)
    values = np.array([v for _, v in pairs], np.float32)

    def lr_fn(step):
        return values[int(np.searchsorted(boundaries, int(step), side="right"))]

    return lr_fn


def global_norm(grads, sharded=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a 0-d tensor.  sharded:
    (flags, group) when the leaves flagged are this rank's shards of leaves
    sharded over the model group: their squares are summed over the group,
    the whole leaves' counted once, so every rank reads the norm of the whole
    gradient."""
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded is None:
        return torch.linalg.vector_norm(norms)
    flags, group = sharded
    mask = torch.tensor(flags, dtype=torch.bool, device=norms.device)
    sq = norms * norms
    return torch.sqrt(mesh_lib.all_reduce(sq[mask].sum(), group) + sq[~mask].sum())


class Optimizer:
    """Adam on a learning-rate schedule, with the optional clip."""

    def __init__(self, lr_schedule, grad_clip: bool = False, sharded=None):
        """sharded: (flags, group) when the params are sharded over a model
        group (mesh.sharded_norm): the leaves flagged (in leaves order) are
        shards, and the clip's global norm sums their squares over it."""
        self.lr_fn = piecewise_constant_lr(lr_schedule)
        self.grad_clip = grad_clip
        self.sharded = sharded

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return {"count": 0, "mu": tree_lib.tree_map(zeros, params),
                "nu": tree_lib.tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """Apply one update to ``params`` in place; returns the new state
        (its moment tensors updated in place)."""
        g = tree_lib.leaves(grads)
        p = tree_lib.leaves(params)
        mu = tree_lib.leaves(opt_state["mu"])
        nu = tree_lib.leaves(opt_state["nu"])
        count = opt_state["count"]
        if self.grad_clip:
            norm = global_norm(g, self.sharded)
            g = torch._foreach_div(g, torch.where(norm < 1.0, torch.ones_like(norm), norm))
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        n = np.float32(count + 1)
        bc1 = np.float32(1.0) - np.float32(ADAM_B1) ** n
        bc2 = np.float32(1.0) - np.float32(ADAM_B2) ** n
        denom = torch._foreach_div(nu, float(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu, float(bc1))
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, float(-self.lr_fn(count)))
        torch._foreach_add_(p, upd)
        return {"count": count + 1, "mu": opt_state["mu"], "nu": opt_state["nu"]}


def make_optimizer(lr_schedule, grad_clip: bool = False, sharded=None) -> Optimizer:
    return Optimizer(lr_schedule, grad_clip=grad_clip, sharded=sharded)


class MultiTransform:
    """optax.multi_transform over the labels 'train' (``inner``) and 'freeze'
    (optax.set_to_zero): the inner optimizer sees only the trained leaves,
    so they alone hold Adam moments and make up the clip's global norm, and
    a frozen leaf never moves.  labels: a tree of the two strings shaped as
    the params.  State: the inner optimizer's, over the trained leaves in
    ``tree.leaves`` order."""

    def __init__(self, inner: Optimizer, labels):
        self.inner = inner
        self.lr_fn = inner.lr_fn
        self.labels = tree_lib.leaves(labels)
        if not set(self.labels) <= {"train", "freeze"}:
            raise ValueError(f"labels must be 'train' or 'freeze': {sorted(set(self.labels))}")

    def _trained(self, tree) -> list:
        flat = tree_lib.leaves(tree)
        if len(flat) != len(self.labels):
            raise ValueError(f"{len(flat)} leaves against {len(self.labels)} labels")
        return [x for x, label in zip(flat, self.labels) if label == "train"]

    def init(self, params):
        return self.inner.init(self._trained(params))

    @property
    def sharded(self):
        return self.inner.sharded

    def update(self, grads, opt_state, params):
        return self.inner.update(self._trained(grads), opt_state, self._trained(params))


def ema_decay_at(step) -> np.float32:
    """TF's ExponentialMovingAverage decay with num_updates warm-up, in f32."""
    t = np.float32(step)
    return min(np.float32(EMA_DECAY), (np.float32(1.0) + t) / (np.float32(10.0) + t))


@torch.no_grad()
def ema_update(ema_params, new_params, step):
    """shadow <- d * shadow + (1 - d) * param, in place."""
    d = ema_decay_at(step)
    e = tree_lib.leaves(ema_params)
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, tree_lib.leaves(new_params), alpha=float(np.float32(1.0) - d))
    return ema_params
