"""Batch synthesis over files (counterparts of generate_wavenet and
generate_parallel_wavenet in nsynth_wavenet_tpu/evaluation.py): wav or mel
files -> mel batch on the host -> Fastgen.generate_cuda (teacher; bf16, or
W8A8 with per-row scales or with static scales calibrated on the sources,
one-shot or streamed) or
parallelgen.synthesize_cuda / StudentStreamer (student) on the device ->
gen_*.wav.

In a process group of several ranks (the eval CLIs' --multihost under
torchrun) each batch is split over the ranks of a data mesh that divides it
(mesh.mesh_for_batch, where the JAX package's evaluation takes
data_mesh_for_batch, the same search): the teacher through Fastgen.generate_cuda_sharded (each rank's rows with its
folded seed), the student through parallelgen.synthesize_sharded (its rows
of the whole batch's noise); rank 0 writes the wavs."""

import dataclasses
import glob
import logging
import os
import time

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib

log = logging.getLogger(__name__)


def discover_files(source_path: str, npy_only: bool = False):
    """source_path: a .wav/.npy file or a directory of them; .wav preferred
    when both exist, unless npy_only (then the .npy mels alone)."""
    if os.path.isdir(source_path):
        wavs = sorted(glob.glob(os.path.join(source_path, "*.wav")))
        npys = sorted(glob.glob(os.path.join(source_path, "*.npy")))
        files = npys if (npy_only or not wavs) else wavs
    else:
        files = [source_path]
    if not files:
        raise FileNotFoundError(f"no .wav/.npy inputs under {source_path}")
    return files


def load_mel_batch(files, sample_length: int = -1):
    """Wavs (or [T, num_mel] .npy mels) -> zero-padded mel batch [B, T, num_mel].
    sample_length > 0 truncates each wav."""
    if os.path.splitext(files[0])[1] == ".npy":
        mels = [np.load(f).astype(np.float32) for f in files]
        out = np.zeros((len(mels), max(m.shape[0] for m in mels), mels[0].shape[1]), np.float32)
        for i, m in enumerate(mels):
            out[i, : m.shape[0]] = m
        return out
    waves = []
    for f in files:
        wav, _ = wav_io.read_wav(f, expect_sr=16000)
        waves.append(wav[:sample_length] if sample_length > 0 else wav)
    batch = np.zeros((len(waves), max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    return stft_ops.melspectrogram_np(batch)


def _fixed_len(w, n):
    """Pad or trim a 1-D wav to exactly n samples (calibration batches stack)."""
    out = np.zeros(n, np.float32)
    k = min(len(w), n)
    out[:k] = w[:k]
    return out


def load_eval_model(ckpt_dir: str, device="cuda"):
    """(cfg, params) of a teacher or student run directory written by the
    port's trainers: the EMA export under <ckpt_dir>/ema (params.npz, meta.json) when
    there is one, else the EMA of the latest checkpoint under <ckpt_dir>/ckpt
    with the run's config json."""
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
    from nsynth_wavenet_tpu_torch.training.runner import find_config_json

    ema_dir = os.path.join(ckpt_dir, "ema")
    if os.path.isfile(os.path.join(ema_dir, "params.npz")):
        return (config_lib.load_config(os.path.join(ema_dir, "meta.json")),
                ckpt_lib.load_params(ema_dir, device=device))
    cfg = config_lib.load_config(find_config_json(ckpt_dir))
    state = ckpt_lib.CheckpointManager(os.path.join(ckpt_dir, "ckpt")).restore(device=device)
    if state is None:
        raise FileNotFoundError(f"no EMA export and no checkpoint under {ckpt_dir}")
    return cfg, state["ema"]


def generate_wavenet(source_path, params_npz, config_json, save_path, batch_size=8, seed=0,
                     device="cuda", sample_length=-1, streaming_chunk=None, int8=False,
                     int8_static=False, ckpt_dir=None, npy_only=False):
    """Teacher synthesis of every file under source_path with the weights of a
    golden-format params.npz and its config json, or (ckpt_dir, with
    params_npz and config_json None) of a training run directory
    (load_eval_model); writes gen_<name>.wav files and returns their
    paths.  sample_length > 0 truncates the input wavs.  The CUDA kernel
    masks the rows past the batch in its tiles; int8 without int8_static
    (per-row scales) caps batch_size near 1 900 at full width
    (Fastgen.generate_cuda).
    streaming_chunk: generate in kernel calls of that many samples with the
    state carried, so a call's buffers do not grow with the utterance.
    int8: W8A8, int8 weights and ring rows with per-row activation and gate
    scales; nothing is calibrated, so mel-only .npy sources serve as well.
    int8 with int8_static: static per-layer activation scales calibrated on
    the first up to 8 .wav sources (each fitted to 16 000 samples) and the
    fixed gate scale; it needs .wav sources.  npy_only: serve the .npy mels
    of a directory that holds .wav files as well (discover_files)."""
    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    cfg, params = _model_and_params(params_npz, config_json, ckpt_dir, device)
    if not isinstance(cfg, config_lib.WavenetConfig):
        raise ValueError(f"{config_json or ckpt_dir} is a student config: use "
                         "generate_parallel_wavenet (eval_parallel_wavenet_torch.py)")
    if int8_static and not int8:
        raise ValueError("int8_static needs int8")
    fg = Fastgen(Wavenet(dataclasses.replace(cfg, use_as_teacher=True)))
    os.makedirs(save_path, exist_ok=True)
    files = discover_files(source_path, npy_only)
    act_amax = None
    if int8_static:
        cal_files = [f for f in files if f.endswith(".wav")][:8]
        if not cal_files:
            raise ValueError("static activation scales need .wav sources to calibrate on")
        cal_wav = np.stack([_fixed_len(wav_io.read_wav(f, expect_sr=16000)[0], 16000)
                            for f in cal_files])
        act_amax = fg.calibrate_act_amax(
            params, torch.from_numpy(cal_wav).to(device),
            torch.from_numpy(stft_ops.melspectrogram_np(cal_wav)).to(device))
        log.info("calibrated static activation scales on %d wavs", len(cal_files))
    kw = fk.build_kernel_weights(cfg, params, weight_dtype="int8" if int8 else "bf16",
                                 act_amax=act_amax, gate_static=int8_static)
    outputs = []
    for i in range(0, len(files), batch_size):
        chunk = files[i : i + batch_size]
        mel = load_mel_batch(chunk, sample_length)
        t0 = time.time()
        mel = torch.from_numpy(mel).to(device)
        mesh = _batch_mesh(len(chunk))
        if mesh is None:
            audio = fg.generate_cuda(params, mel, seed + i, kw=kw, chunk=streaming_chunk or None)
        elif mesh.member:
            audio = fg.generate_cuda_sharded(params, mel, seed + i, mesh, kw=kw,
                                             chunk=streaming_chunk or None)
        else:
            continue
        audio = audio.cpu().numpy()
        dt = time.time() - t0
        audio_sec = audio.size / 16000.0
        log.info("fastgen batch of %d: %.2f audio-sec in %.2fs (Delay %.3f)",
                 len(chunk), audio_sec, dt, dt / audio_sec)
        outputs += _write_batch(save_path, chunk, audio)
    mesh_lib.barrier()
    return outputs


def _batch_mesh(batch_size):
    """The data mesh a batch is split over, or None in one process."""
    return mesh_lib.mesh_for_batch(batch_size) if mesh_lib.process_count() > 1 else None


def _write_batch(save_path, files, audio):
    """gen_<name>.wav of each row (written by rank 0); returns the paths."""
    outputs = []
    for f, wav in zip(files, audio):
        out = os.path.join(save_path, "gen_" + os.path.splitext(os.path.basename(f))[0] + ".wav")
        if mesh_lib.process_index() == 0:
            wav_io.write_wav(out, wav)
        outputs.append(out)
    return outputs


def _model_and_params(params_npz, config_json, ckpt_dir, device):
    """(cfg, params) from a golden-format params.npz and its config json, or
    from a training run directory (load_eval_model)."""
    if ckpt_dir is None:
        return config_lib.load_config(config_json), weights.load_npz(params_npz, device=device)
    if params_npz is not None or config_json is not None:
        raise ValueError("pass either ckpt_dir or params_npz and config_json")
    return load_eval_model(ckpt_dir, device=device)


def generate_parallel_wavenet(source_path, params_npz, config_json, save_path, batch_size=4,
                              seed=0, device="cuda", sample_length=-1, streaming_chunk=None,
                              ckpt_dir=None, npy_only=False):
    """One-shot student synthesis of every file under source_path with the
    weights of a golden-format params.npz and its config json, or (ckpt_dir,
    with params_npz and config_json None) of a student run directory
    (load_eval_model), through the fused serving path
    (the flow trunks in the CUDA kernel on a CUDA device: its compact mode for
    a bf16 student, its f32-conditioning mode for an f32 one); writes
    gen_<name>.wav files, logs the Delay metric per batch and returns the
    paths.  streaming_chunk: stream the flows in chunks of that many samples
    with carried dilation state (parallelgen.StudentStreamer), for a working
    set that does not grow with the utterance.  Any batch size runs as it is.
    npy_only: serve the .npy mels of a directory that holds .wav files as
    well (discover_files)."""
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet

    cfg, params = _model_and_params(params_npz, config_json, ckpt_dir, device)
    if not isinstance(cfg, config_lib.ParallelWavenetConfig):
        raise ValueError(f"{config_json or ckpt_dir} is a teacher config: use generate_wavenet "
                         "(eval_wavenet_torch.py)")
    pwn = ParallelWavenet(cfg)
    streamer = parallelgen.StudentStreamer(pwn, chunk=streaming_chunk) if streaming_chunk else None
    os.makedirs(save_path, exist_ok=True)
    files = discover_files(source_path, npy_only)
    outputs = []
    for i in range(0, len(files), batch_size):
        chunk = files[i : i + batch_size]
        mel = torch.from_numpy(load_mel_batch(chunk, sample_length)).to(device)
        generator = torch.Generator().manual_seed(seed + i)
        t0 = time.time()
        mesh = _batch_mesh(len(chunk))
        if mesh is not None and not mesh.member:
            continue
        if mesh is not None and streamer is not None:
            rows = mesh_lib.rows(mesh, len(chunk))
            base_x = pwn.base_noise(generator, len(chunk), pwn.sample_length(mel.shape[1]),
                                    device)[rows]
            audio = torch.cat(mesh_lib.all_gather(
                streamer.synthesize(params, mel[rows], base_x=base_x),
                mesh.group(mesh_lib.DATA_AXIS)))
        elif mesh is not None:
            audio = parallelgen.synthesize_sharded(pwn, params, mel, generator, mesh, fused=True)
        elif streamer is not None:
            audio = streamer.synthesize(params, mel, generator)
        else:
            audio = parallelgen.synthesize_cuda(pwn, params, mel, generator)
        audio = audio.cpu().numpy()
        dt = time.time() - t0
        audio_sec = audio.size / 16000.0
        log.info("parallelgen batch of %d: %.2f audio-sec in %.2fs (Delay %.3f)",
                 len(chunk), audio_sec, dt, dt / audio_sec)
        outputs += _write_batch(save_path, chunk, audio)
    mesh_lib.barrier()
    return outputs
