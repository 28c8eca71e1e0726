"""Train golden regression checkpoints with the port (counterpart of the JAX
package's tools/make_golden_ckpt.py): one per output head, and the IAF
student.

Trains a quality-smoke teacher (width 128) for the requested head on the
formant-synthesized pseudo-speech corpus with the port's runner, rounds its
EMA weights through the committed int8 storage, free-runs the round-tripped
weights from the held-out mels of METRIC_SEEDS (the plain
``Fastgen.generate``; the student through the plain
``parallelgen.synthesize``) and writes, in the committed layout with the JAX
tool's keys,

    <out_dir>/tiny_{head}/params.npz   (EMA weights, int8 per output channel
                                        + f32 scales; 1-D and small arrays f32)
    <out_dir>/tiny_{head}/meta.json    (config + measured free-run corr)

(``tiny_student`` with --student).  The JAX tool asserts that the model
tracks its conditioning (matched corr over mismatched + 0.1) before it writes
into tests/golden/; this tool never writes there: it writes under --out_dir
whatever the reading, and returns 1 when the model does not track.

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.make_golden_ckpt [--head ce|mol|gauss]
        [--student] [--steps 30000] [--batch 8] [--workdir DIR] [--out_dir DIR]
        [--device cpu]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs
from nsynth_wavenet_tpu_torch.utils import quality

HEADS = ("ce", "mol", "gauss")
# held-out utterance seeds: METRIC_SEEDS produce the meta.json metrics;
# PAD_SEEDS let a check run the JAX package's TPU kernel at batch 8
METRIC_SEEDS = (101, 202, 303, 404)
PAD_SEEDS = (505, 606, 707, 808)
GEN_SAMPLES = 12000  # 0.75 s
GEN_SEED = 7
TRACK_GAP = 0.1  # matched corr over mismatched that a golden must show
CORPUS = "data/synthetic.py make_speechlike_corpus(seed=0)"


def golden_config(head: str = "ce"):
    return config_lib.wavenet_config_from_dict(dict(qs.head_cfg(head),
                                                    compute_dtype="float32"))


def quantize_flat(flat):
    """int8 per-output-channel (last axis) storage; 1-D arrays and arrays of
    fewer than 1024 values stay f32 (the JAX tool's rule and arithmetic)."""
    out = {}
    for k, a in flat.items():
        if a.ndim < 2 or a.size < 1024:
            out[k] = a.astype(np.float32)
            continue
        amax = np.maximum(np.abs(a).max(axis=tuple(range(a.ndim - 1)), keepdims=True), 1e-8)
        scale = (amax / 127.0).astype(np.float32)
        out[k + "#q"] = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        out[k + "#s"] = scale
    return out


def round_trip(ema):
    """(stored int8 dict, the port's params from it): the EMA weights as the
    committed storage holds them, then read back."""
    stored = quantize_flat(weights.flatten(weights.to_jax_params(ema)))
    device = next(iter(weights.flatten(ema).values())).device
    return stored, weights.from_jax_params(weights.unflatten(weights.dequantize_npz(stored)), device)


def write_golden(out_dir, stored, meta):
    """params.npz (compressed) and meta.json of a golden directory; returns
    the params.npz size in MB."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "params.npz"), **stored)
    with open(os.path.join(out_dir, "meta.json"), "wt") as f:
        json.dump(meta, f, indent=2)
    return os.path.getsize(os.path.join(out_dir, "params.npz")) / 1e6


def _speech_corpus(workdir):
    ds_dir = os.path.join(workdir, "ds")
    if not os.path.exists(os.path.join(ds_dir, "index.json")):
        qs.make_speech_corpus(ds_dir)
    return ds_dir


def _meta(config, steps, m_corr, mm_corr, **extra):
    return {"config": config, **extra, "train_steps": steps, "corpus": CORPUS,
            "eval_seeds": list(METRIC_SEEDS), "batch_pad_seeds": list(PAD_SEEDS),
            "gen_samples": GEN_SAMPLES, "matched_corr": round(m_corr, 4),
            "mismatched_corr": round(mm_corr, 4)}


def make_golden(head, steps, batch, workdir, out_dir, device="cuda"):
    """Train the head's teacher, round-trip, free-run, write
    <out_dir>/tiny_{head}.  Returns (the golden directory, matched corr,
    mismatched corr, whether it tracks)."""
    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.training import runner

    os.makedirs(workdir, exist_ok=True)
    ds_dir = _speech_corpus(workdir)
    config = dict(qs.head_cfg(head), compute_dtype="float32")
    cfg_path = qs._write_config(os.path.join(workdir, f"golden_{head}.json"),
                                dict(config, num_iters=steps))
    run_dir, state = runner.train_wavenet(
        train_path=ds_dir, config_path=cfg_path, log_root=os.path.join(workdir, "runs"),
        total_batch_size=batch, ckpt_every_steps=10000, device=device)

    # round-trip through the committed int8 storage BEFORE measuring
    stored, params = round_trip(state["ema"])
    mels, _ = quality.eval_mels(METRIC_SEEDS)
    # the metrics read the first GEN_SAMPLES samples; an AR run's first
    # samples do not depend on how many follow
    audio = Fastgen(Wavenet(golden_config(head))).generate(
        params, torch.from_numpy(mels).to(device), torch.Generator().manual_seed(GEN_SEED),
        length=GEN_SAMPLES).cpu().numpy()
    m_corr, mm_corr = qs.mel_track_corr(audio, mels, GEN_SAMPLES)
    tracks = m_corr > mm_corr + TRACK_GAP
    print(f"golden {head} free-run tracking: matched {m_corr:.3f} vs mismatched {mm_corr:.3f}")
    if not tracks:
        print("golden model does not track conditioning")
    out = os.path.join(out_dir, f"tiny_{head}")
    size = write_golden(out, stored, _meta(config, steps, m_corr, mm_corr, head=head))
    print(f"wrote {out} ({size:.1f} MB), run dir {run_dir}")
    return out, m_corr, mm_corr, tracks


def make_student_golden(steps, batch, workdir, out_dir, device="cuda"):
    """Distill a Gaussian IAF student from a freshly trained gauss teacher on
    the pseudo-speech corpus and write <out_dir>/tiny_student: the
    trained-weights artifact for one-shot serving regression gates.  Returns
    as make_golden does."""
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.training import runner

    os.makedirs(workdir, exist_ok=True)
    ds_dir = _speech_corpus(workdir)
    te_cfg = dict(qs.GAUSS_TEACHER_CFG, num_iters=steps)
    te_dir, _ = runner.train_wavenet(
        train_path=ds_dir,
        config_path=qs._write_config(os.path.join(workdir, "golden_te_gauss.json"), te_cfg),
        log_root=os.path.join(workdir, "runs"), total_batch_size=batch, ckpt_every_steps=10000,
        device=device)
    st_cfg = dict(qs.STUDENT_CFG, num_iters=steps)
    st_dir, st_state = runner.train_parallel_wavenet(
        train_path=ds_dir, teacher_dir=te_dir,
        config_path=qs._write_config(os.path.join(workdir, "golden_student.json"), st_cfg),
        log_root=os.path.join(workdir, "runs"), total_batch_size=4, ckpt_every_steps=10000,
        device=device)

    # round-trip through the committed int8 storage BEFORE measuring
    stored, params = round_trip(st_state["ema"])
    pwn = ParallelWavenet(config_lib.pwn_config_from_dict(st_cfg))
    mels, _ = quality.eval_mels(METRIC_SEEDS)
    audio = parallelgen.synthesize(pwn, params, torch.from_numpy(mels).to(device),
                                   torch.Generator().manual_seed(GEN_SEED)).cpu().numpy()
    m_corr, mm_corr = qs.mel_track_corr(audio, mels, GEN_SAMPLES)
    tracks = m_corr > mm_corr + TRACK_GAP
    print(f"golden student one-shot tracking: matched {m_corr:.3f} vs "
          f"mismatched {mm_corr:.3f}")
    if not tracks:
        print("golden student does not track conditioning")
    out = os.path.join(out_dir, "tiny_student")
    size = write_golden(out, stored, _meta(st_cfg, steps, m_corr, mm_corr, student=True,
                                           pairing="gauss", teacher=te_cfg))
    print(f"wrote {out} ({size:.1f} MB), runs {te_dir} / {st_dir}")
    return out, m_corr, mm_corr, tracks


def main(head="ce", student=False, steps=30000, batch=8, workdir=None, out_dir=None,
         device="cuda"):
    workdir = workdir or os.path.join(tempfile.gettempdir(), "golden_ckpt_torch")
    out_dir = out_dir or os.path.join(workdir, "golden")
    if student:
        tracks = make_student_golden(steps, batch, workdir, out_dir, device)[3]
    else:
        tracks = make_golden(head, steps, batch, workdir, out_dir, device)[3]
    return 0 if tracks else 1


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--head", default="ce", choices=list(HEADS))
    ap.add_argument("--student", action="store_true",
                    help="distill the tiny_student golden instead")
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workdir", default=None,
                    help="corpus and training runs (default <tmp>/golden_ckpt_torch)")
    ap.add_argument("--out_dir", default=None,
                    help="where tiny_<head>/ is written (default <workdir>/golden)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return main(args.head, args.student, args.steps, args.batch, args.workdir, args.out_dir,
                args.device)


if __name__ == "__main__":
    sys.exit(cli())
