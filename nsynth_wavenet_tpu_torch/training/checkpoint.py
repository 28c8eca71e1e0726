"""Checkpoints, resume by run directory, and the EMA export (counterpart of
nsynth_wavenet_tpu/training/checkpoint.py, which writes Orbax trees):

  * ``CheckpointManager`` keeps the whole train state {params, opt_state,
    ema, step} as torch's own file ``<dir>/<step>/state.pt``, written to a
    temporary directory and renamed into place, the newest ``max_to_keep``
    kept;
  * ``export_ema`` writes the EMA weights as a golden-format ``params.npz``
    (plain f32 keys, read by ``weights.load_npz``) with a ``meta.json`` whose
    'config' is the run's config: what the eval CLIs' ``--ckpt_dir`` reads.

Over a device mesh (parallel/mesh.py) a checkpoint is always the whole state
in the reference's layout: ``save`` gathers the model-sharded leaves of every
rank (collective), rank 0 writes, and every rank passes a barrier;
``restore`` reads on every rank and takes this rank's shard.  This is the
counterpart of the JAX runner's collective Orbax save of a state sharded
across processes.
"""

import dataclasses
import json
import os
import shutil
from typing import Optional

import torch

from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib

STATE_NAME = "state.pt"


class CheckpointManager:
    """mesh, labels: the state is sharded over ``mesh``
    (mesh.shard_train_state with these labels)."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None, labels=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh, self.labels = mesh, labels
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_NAME)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state):
        if self.mesh is not None:
            state = mesh_lib.gather_train_state(state, self.mesh, self.labels)
        if mesh_lib.process_index() == 0:
            self._write(step, state)
        mesh_lib.barrier()

    def _write(self, step: int, state):
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".{int(step)}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_NAME))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self, step: Optional[int] = None, device="cuda"):
        """The state saved at ``step`` (default the latest) on ``device``, or
        None when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self.directory, str(int(step)), STATE_NAME),
                           map_location=device, weights_only=True)
        if self.mesh is not None:
            state = mesh_lib.shard_train_state(state, self.mesh, self.labels)
        return state


def export_ema(state, path: str, cfg):
    """Write the EMA weights of a whole state (the runners return it
    gathered) to ``path``/params.npz and the run's config to
    ``path``/meta.json ({'config': ..., 'step': ...}); process 0 writes."""
    if mesh_lib.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        weights.save_npz(os.path.join(path, "params.npz"), state["ema"])
        write_export_meta(path, dataclasses.asdict(cfg), int(state["step"]))
    mesh_lib.barrier()


def write_export_meta(path: str, config: dict, step: Optional[int]):
    """``path``/meta.json of an EMA export: {'config': config, 'step': step}."""
    with open(os.path.join(path, "meta.json"), "wt") as f:
        json.dump({"config": config, "step": step}, f, indent=2)


def load_params(path: str, device="cuda"):
    """Params from an ``export_ema`` directory (or its params.npz)."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.npz")
    return weights.load_npz(path, device=device)
