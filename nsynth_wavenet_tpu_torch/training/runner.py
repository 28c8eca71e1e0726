"""Training runs (counterparts of train_wavenet, load_teacher and
train_parallel_wavenet in nsynth_wavenet_tpu/training/runner.py): the run
directory (a new one under ``log_root`` named by the config slug, or resume
from ``logdir``), data-dependent init of weight-normed models, the step loop,
metrics every LOG_EVERY steps, checkpoints every ``ckpt_every_steps`` and at
the target, a checkpoint on SIGTERM / SIGINT, and an optional torch.profiler
window.

Over a device mesh (parallel/mesh.py), one process per device:
``multihost`` joins the process group of torch's ``env://`` variables
(torchrun's), ``n_model`` shards the model's channels over that many ranks,
``n_seq`` the time axis of every crop (each rank of a seq line runs its
chunk, exchanging halos with its neighbours) and the data axis takes the
rest of them.  Every rank of a data index (its model and seq ranks alike)
reads that index's share of the records with its seed offset by the index
and steps on those rows alone (no rank assembles the global batch, as JAX's
put_global_batch does), the data-dependent init runs on process 0's init
batch on every rank, the checkpoints hold the whole state
(training/checkpoint.py), and train.log, metrics.jsonl, TensorBoard (with
the DETAIL_LOG histograms) and the profile come from rank 0.

On resume the state comes from the latest checkpoint and the data iterators
restart from their seeds, as the JAX runner's do; a step's random draws
(the teacher's dropout, the student's noise) depend on (seed + 2, step)
alone.  The student's run reads a teacher run directory that train_wavenet
wrote and keeps its power-loss statistics in norm_stats.npz.
"""

import dataclasses
import glob
import logging
import os
import shutil
import time

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch.data import dataset as data_lib
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.utils import logging_utils
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

LOG_EVERY = 100
STOP_SYNC_EVERY = 10


def maybe_init_distributed(multihost: bool, device="cuda") -> torch.device:
    """With multihost, join the process group that torch's env:// variables
    describe (mesh.init_distributed: nccl and cuda:LOCAL_RANK for a CUDA
    device, gloo for the CPU) and return this rank's device; else the
    device as it is."""
    if multihost:
        return mesh_lib.init_distributed(device)
    return torch.device(device)


def local_batch_size(total_batch_size: int, mesh) -> int:
    """Rows of the global batch this rank's data index produces."""
    n = mesh.size(mesh_lib.DATA_AXIS)
    if total_batch_size % n:
        raise ValueError(f"total_batch_size {total_batch_size} does not divide over {n} data ranks")
    return total_batch_size // n


def broadcast_from_host0(x):
    """A host array, or a tuple of them, made identical on every process
    (process 0 wins): the data-dependent-init batch and the power-loss
    statistics, which every rank must see alike or the replicas part."""
    if mesh_lib.process_count() == 1:
        return x
    if isinstance(x, tuple):
        return tuple(broadcast_from_host0(a) for a in x)
    return mesh_lib.broadcast(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def make_stop_sync():
    """Agreement of every process on the GracefulShutdown flag: each process
    gets its signal at another step, while the gradient average and the
    checkpoint save are collectives, so the flags are max-reduced at the same
    step boundaries (every STOP_SYNC_EVERY steps).  One process: the local
    flag, every step."""
    if mesh_lib.process_count() == 1:
        return lambda requested, step: requested

    def sync(requested: bool, step: int) -> bool:
        if step % STOP_SYNC_EVERY != 0:
            return False
        flag = torch.tensor([int(requested)])
        return bool(mesh_lib.all_reduce(flag, mesh_lib.dist.group.WORLD,
                                        op=mesh_lib.dist.ReduceOp.MAX).item())

    return sync


def _shared_time_stamp() -> str:
    """The run directory's time stamp, process 0's on every process (each
    process's own clock could name another second)."""
    stamp = time.strftime("%m%d_%H%M%S")
    raw = np.frombuffer(stamp.encode("ascii"), dtype=np.uint8)
    return bytes(broadcast_from_host0(raw)).decode("ascii")


class GracefulShutdown:
    """The first SIGTERM / SIGINT sets ``requested``: the loop ends the step
    in flight, saves a checkpoint and returns.  A second signal falls back to
    the previous handler.  A no-op off the main thread."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def __enter__(self):
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):
                pass
        return self

    def _handle(self, sig, frame):
        import signal

        if self.requested:
            prev = self._prev.get(sig, signal.SIG_DFL)
            if prev is signal.SIG_IGN:
                return
            signal.signal(sig, prev)
            if callable(prev):
                prev(sig, frame)
                return
            raise KeyboardInterrupt
        self.requested = True

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False


class Profiler:
    """torch.profiler over steps [start_step, start_step + num_steps); the
    trace goes to <run_dir>/profile/trace.json (chrome trace format)."""

    def __init__(self, run_dir, start_step, num_steps):
        self.dir = os.path.join(run_dir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + num_steps if num_steps else 0
        self._prof = None

    def maybe_update(self, step):
        if self.stop_step and self._prof is None and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
            self.stop_step = 0


def find_config_json(run_dir: str) -> str:
    jsons = [j for j in glob.glob(os.path.join(run_dir, "*.json"))
             if not os.path.basename(j).startswith("norm_stats")]
    if len(jsons) != 1:
        raise FileNotFoundError(f"expected exactly one config json in {run_dir}: {jsons}")
    return jsons[0]


def resolve_run_dir(log_root: str, logdir: str, config_path: str, model_tag: str):
    """New run: <log_root>/<slug>-<time> with a copy of the config json.
    Resume: ``logdir`` and the config json inside it.  Returns (run_dir, cfg,
    resumed)."""
    if log_root:
        if not config_path:
            raise ValueError("a new run under --log_root needs --config")
        cfg = config_lib.load_config(config_path)
        slug = config_lib.config_slug(cfg, model_tag)
        run_dir = os.path.join(log_root, f"{slug}-{_shared_time_stamp()}")
        os.makedirs(run_dir, exist_ok=True)
        if mesh_lib.process_index() == 0:
            shutil.copy(config_path, run_dir)
        mesh_lib.barrier()
        return run_dir, cfg, False
    return logdir, config_lib.load_config(find_config_json(logdir)), True


def _init_logging(log, array, name):
    array = np.asarray(array)
    log.info("initial %s.m %.5f, %s.std %.5f, %s.min %.5f, %s.max %.5f",
             name, array.mean(), name, array.std(), name, array.min(), name, array.max())


def _log_teacher_init_stats(log, loss_type, out_params):
    out = out_params.cpu().numpy()
    if loss_type == "mol":
        _, mean, log_scale = np.split(out, 3, axis=2)
        _init_logging(log, mean, "mean")
        _init_logging(log, np.exp(np.maximum(log_scale, -7.0)), "scale")
    elif loss_type == "gauss":
        mean, log_std = np.split(out, 2, axis=2)
        _init_logging(log, mean, "mean")
        _init_logging(log, np.exp(np.maximum(log_std, -7.0)), "std")


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs a CUDA device; pass device='cpu' for the CPU")
    return device


def _training_mesh(multihost, total_batch_size, n_model, n_seq, device):
    """(device, mesh) of a run: the mesh must take every rank (the data axis
    divides the global batch)."""
    device = _check_device(maybe_init_distributed(multihost, device))
    mesh = mesh_lib.mesh_for_batch(total_batch_size, n_model=n_model, n_seq=n_seq)
    world = mesh_lib.process_count()
    if int(np.prod(list(mesh.shape.values()))) != world:
        raise ValueError(f"total_batch_size {total_batch_size} with n_model {n_model} and n_seq "
                         f"{n_seq} leaves ranks of {world} idle (mesh {mesh.shape})")
    return device, mesh


def _host_metrics(metrics) -> dict:
    """Floats of the scalar metrics; DETAIL_LOG histograms (dicts of
    logging_utils.device_histogram) pass through for MetricsWriter."""
    return {k: v if logging_utils.is_histogram(v) else float(v) for k, v in metrics.items()}


def _run_logger(run_dir):
    """train.log and the console on rank 0; the other ranks log nothing."""
    if mesh_lib.process_index() == 0:
        return logging_utils.add_log_file(run_dir)
    log = logging.getLogger(f"{logging_utils.LOGGER_NAME}.rank{mesh_lib.process_index()}")
    log.propagate = False
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    return log


def train_wavenet(
    train_path: str,
    config_path: str = "",
    log_root: str = "",
    logdir: str = "/tmp/nsynth_wavenet_tpu_torch",
    total_batch_size: int = 4,
    num_steps: int = None,
    ckpt_every_steps: int = 2000,
    seed: int = 0,
    multihost: bool = False,
    profile_steps: int = 0,
    n_model: int = 1,
    n_seq: int = 1,
    device="cuda",
):
    """Teacher training; returns (run_dir, state), the state whole (gathered
    over the model axis) on every rank."""
    device, mesh = _training_mesh(multihost, total_batch_size, n_model, n_seq, device)
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
    from nsynth_wavenet_tpu_torch.training import optimizer as opt_lib
    from nsynth_wavenet_tpu_torch.training import train_lib

    run_dir, cfg, resumed = resolve_run_dir(log_root, logdir, config_path, "wavenet")
    log = _run_logger(run_dir)
    if resumed:
        log.info("Continue running in %s", run_dir)
    log.info("\n%s", logging_utils.config_summary(cfg))
    log.info("mesh %s over %d processes", mesh.shape, mesh_lib.process_count())

    model = Wavenet(cfg)
    mesh_lib.seq_chunk(cfg.wave_length, mesh)  # refuse a crop the seq axis does not divide
    data_index, n_data = mesh.index(mesh_lib.DATA_AXIS), mesh.size(mesh_lib.DATA_AXIS)
    ds = data_lib.Dataset(train_path, process_index=data_index, process_count=n_data)
    log.info("crop gather: %s", "the native C++ sampler" if ds.native else "numpy")
    mgr = ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt"), mesh=mesh)
    state = mgr.restore(device=device)
    if state is not None:
        log.info("Restored checkpoint at step %d", state["step"])
        params = state["params"]
    else:
        params = model.init_params(seed, device=device)
        if cfg.use_weight_norm:
            log.info("Calculate initial statistics (data-dependent init).")
            init_wav = broadcast_from_host0(
                ds.get_init_batch(total_batch_size, cfg.wave_length, seed=seed))
            init_mel = torch.from_numpy(stft_ops.melspectrogram_np(init_wav)).to(device)
            gen = train_lib.dropout_generator(seed + 1, 0, device)
            out_params, params = train_lib.run_data_dep_init(
                model, params, torch.from_numpy(init_wav).to(device), init_mel, gen)
            _log_teacher_init_stats(log, cfg.loss_type, out_params)
        params = mesh_lib.replicate_tree(params)
    optimizer = opt_lib.make_optimizer(cfg.lr_schedule, grad_clip=cfg.grad_clip,
                                       sharded=mesh_lib.sharded_norm(params, mesh))
    if state is None:
        state = mesh_lib.shard_train_state(train_lib.make_train_state(params, optimizer), mesh)

    step_fn = train_lib.make_wavenet_train_step(model, optimizer, mesh=mesh)
    cond_gap_fn = train_lib.make_cond_gap_fn(model, mesh=mesh)
    it = ds.batch_iterator(local_batch_size(total_batch_size, mesh), cfg.wave_length,
                           seed=seed + data_index)

    def run_step(state):
        wav = torch.from_numpy(next(it)).to(device)
        state, metrics = step_fn(state, wav, seed + 2)
        return state, metrics, wav

    def report(state, metrics, wav, m):
        m.update(_host_metrics(metrics))
        if total_batch_size > 1:
            m["cond_gap"] = cond_gap_fn(state["params"], wav)
        log.info("step %d loss %.4f lr %.2e cond_gap %.4f (%.2f steps/s)", state["step"],
                 m["loss"], m["learning_rate"], m.get("cond_gap", 0.0), m["steps_per_sec"])

    state = _step_loop(run_dir, log, mgr, state, run_step, report, [it],
                       target=num_steps if num_steps is not None else cfg.num_iters,
                       ckpt_every_steps=ckpt_every_steps, profile_steps=profile_steps,
                       batch_size=total_batch_size)
    return run_dir, mesh_lib.gather_train_state(state, mesh)


def _step_loop(run_dir, log, mgr, state, run_step, report, iterators, *, target,
               ckpt_every_steps, profile_steps, batch_size):
    """Steps until ``target``: run_step(state) -> (state, metrics, wav);
    every LOG_EVERY steps and at the target report(state, metrics, wav, m)
    fills m (which holds steps_per_sec and utterances_per_sec) and logs it,
    and m goes to metrics.jsonl; checkpoints as the module docstring says.
    Closes the iterators, the metrics writer and train.log's handler.  Every
    rank runs report (it may hold collectives); rank 0 writes and profiles."""
    lead = mesh_lib.process_index() == 0
    writer = logging_utils.MetricsWriter(run_dir) if lead else None
    step = state["step"]
    profiler = Profiler(run_dir, step + 10, profile_steps if lead else 0)
    t_last, s_last = time.time(), step
    should_stop = make_stop_sync()
    try:
        with GracefulShutdown() as stop:
            stopped = False
            while step < target:
                if should_stop(stop.requested, step):
                    stopped = True
                    break
                profiler.maybe_update(step)
                state, metrics, wav = run_step(state)
                step = state["step"]
                if step % LOG_EVERY == 0 or step == target:
                    now = time.time()
                    sps = (step - s_last) / max(now - t_last, 1e-9)
                    t_last, s_last = now, step
                    m = {"steps_per_sec": sps, "utterances_per_sec": sps * batch_size}
                    report(state, metrics, wav, m)
                    if writer is not None:
                        writer.write(step, m)
                if step % ckpt_every_steps == 0 or step == target:
                    mgr.save(step, state)
            if stopped and step % ckpt_every_steps != 0 and step != target:
                log.info("shutdown signal: saving checkpoint at step %d", step)
                mgr.save(step, state)
    finally:
        profiler.close()
        for it in iterators:
            it.close()
        if writer is not None:
            writer.close()
        logging_utils.remove_log_file(run_dir)
    return state


def load_teacher(teacher_dir: str, device="cuda"):
    """(Wavenet with use_as_teacher=True, EMA params of the latest
    checkpoint) of a teacher run directory written by train_wavenet: the
    reference restores the teacher from its EMA shadow."""
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib

    cfg = config_lib.load_config(find_config_json(teacher_dir))
    if not isinstance(cfg, config_lib.WavenetConfig):
        raise ValueError(f"{teacher_dir} holds a student's config, not a teacher's")
    cfg = dataclasses.replace(cfg, use_as_teacher=True)
    ckpt_dir = os.path.join(teacher_dir, "ckpt")
    state = (ckpt_lib.CheckpointManager(ckpt_dir).restore(device=device)
             if os.path.isdir(ckpt_dir) else None)
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return Wavenet(cfg), state["ema"]


def train_parallel_wavenet(
    train_path: str,
    teacher_dir: str,
    config_path: str = "",
    log_root: str = "",
    logdir: str = "/tmp/nsynth_pwn_torch",
    total_batch_size: int = 4,
    num_steps: int = None,
    ckpt_every_steps: int = 2000,
    seed: int = 0,
    multihost: bool = False,
    profile_steps: int = 0,
    n_model: int = 1,
    n_seq: int = 1,
    device="cuda",
):
    """Student distillation from the teacher run directory ``teacher_dir``;
    returns (run_dir, state), the state whole on every rank.  A new run
    restores the teacher, runs the data-dependent init of a weight-normed
    student on an init batch, then copies the teacher's deconv weights into
    the student.  Over a mesh the frozen teacher is sharded with the
    student's rules."""
    device, mesh = _training_mesh(multihost, total_batch_size, n_model, n_seq, device)
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import (
        ParallelWavenet,
        transplant_teacher_deconv,
    )
    from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
    from nsynth_wavenet_tpu_torch.training import train_lib

    run_dir, cfg, resumed = resolve_run_dir(log_root, logdir, config_path, "parallel_wavenet")
    log = _run_logger(run_dir)
    if resumed:
        log.info("Continue running in %s", run_dir)
    log.info("\n%s", logging_utils.config_summary(cfg))
    log.info("mesh %s over %d processes", mesh.shape, mesh_lib.process_count())
    teacher, te_params = load_teacher(teacher_dir, device)
    log.info("teacher from %s\n%s", teacher_dir, logging_utils.config_summary(teacher.cfg))
    pwn = ParallelWavenet(cfg, teacher)
    # refuse a sample length the seq axis does not divide
    mesh_lib.seq_chunk(pwn.sample_length(stft_ops.num_mel_frames(cfg.wave_length)), mesh)
    data_index, n_data = mesh.index(mesh_lib.DATA_AXIS), mesh.size(mesh_lib.DATA_AXIS)
    ds = data_lib.Dataset(train_path, process_index=data_index, process_count=n_data)
    log.info("crop gather: %s", "the native C++ sampler" if ds.native else "numpy")
    params = pwn.init_params(seed, device=device)
    labels = tree_lib.leaves(train_lib.student_param_labels(cfg, params))
    mgr = ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt"), mesh=mesh, labels=labels)
    state = mgr.restore(device=device)
    if state is not None:
        log.info("Restored checkpoint at step %d", state["step"])
        params = state["params"]
    else:
        if cfg.use_weight_norm:
            log.info("Calculate initial statistics (data-dependent init).")
            init_wav = broadcast_from_host0(
                ds.get_init_batch(total_batch_size, cfg.wave_length, seed=seed))
            init_mel = torch.from_numpy(stft_ops.melspectrogram_np(init_wav)).to(device)
            ff, params = pwn.data_dep_init(params, init_mel,
                                           train_lib.dropout_generator(seed + 1, 0, device))
            _init_logging(log, ff["x"].cpu(), "new_x")
            _init_logging(log, ff["mean_tot"].cpu(), "mean")
            _init_logging(log, ff["scale_tot"].cpu(), "scale")
        params = mesh_lib.replicate_tree(transplant_teacher_deconv(params, te_params))
    optimizer = train_lib.make_student_optimizer(cfg, params, mesh)
    if state is None:
        state = mesh_lib.shard_train_state(train_lib.make_train_state(params, optimizer), mesh,
                                           labels)
    te_params = mesh_lib.shard_params(te_params, mesh)

    # the power loss's feature statistics, kept with the run so that a
    # resumed run uses the same ones
    norm_stats = None
    if cfg.norm_feat:
        stats_path = os.path.join(run_dir, "norm_stats.npz")
        # process 0 decides, or a rank could find the file process 0 just wrote
        if broadcast_from_host0(np.array([os.path.exists(stats_path)]))[0]:
            with np.load(stats_path) as z:
                norm_stats = (z["mean"], z["std"])
        else:
            log.info("Calculating STFT feature mean/std for power-loss norm.")
            mean, std = data_lib.spec_feat_mean_std(train_path, pwn.stft_feat, device=device)
            norm_stats = broadcast_from_host0((mean, std))
            if mesh_lib.process_index() == 0:
                np.savez(stats_path, mean=norm_stats[0], std=norm_stats[1])

    step_fn = train_lib.make_pwn_train_step(pwn, te_params, optimizer, norm_stats, mesh=mesh)
    # two crop streams, both advanced every step
    local = local_batch_size(total_batch_size, mesh)
    it = ds.batch_iterator(local, cfg.wave_length, seed=seed + data_index)
    it_rand = ds.batch_iterator(local, cfg.wave_length, seed=seed + 12345 + data_index)

    def run_step(state):
        wav = torch.from_numpy(next(it)).to(device)
        wav_rand = torch.from_numpy(next(it_rand)).to(device)
        state, metrics = step_fn(state, wav, wav_rand, seed + 2)
        return state, metrics, wav

    def report(state, metrics, wav, m):
        m.update(_host_metrics(metrics))
        # hpt, the teacher's cross-entropy term of the KL, can fall at smoke
        # scale where the KL itself is floored by the teacher's own NLL
        hpt = (" hpt %.4f" % m["H_Ps_Pt"]) if "H_Ps_Pt" in m else ""
        log.info("step %d loss %.4f kl %.4f power %.4f%s (%.2f steps/s)", state["step"],
                 m["loss"], m["kl_loss"], m.get("power_loss", float("nan")), hpt,
                 m["steps_per_sec"])

    state = _step_loop(run_dir, log, mgr, state, run_step, report, [it, it_rand],
                       target=num_steps if num_steps is not None else cfg.num_iters,
                       ckpt_every_steps=ckpt_every_steps, profile_steps=profile_steps,
                       batch_size=total_batch_size)
    return run_dir, mesh_lib.gather_train_state(state, mesh, labels)
