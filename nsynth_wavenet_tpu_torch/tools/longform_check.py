"""Long-horizon streaming-serving fidelity check on the port (counterpart of
the JAX package's tools/longform_check.py).

Free-running AR quality over LONG utterances is where a subtly broken
recurrent state (ring phase across chunks, the carried state of a chunked
call) or a drifting sampler shows up: short smokes can pass while tracking
collapses after a few seconds.  This tool loads a TRAINED run directory of
the port's trainers (e.g. from ``quality_smoke --corpus speech``),
synthesizes 8 N-second pseudo-speech utterances through the streaming
serving path and reports the generated-mel vs conditioning-mel correlation
and MCD PER 1-SECOND WINDOW: the gate is that late windows track as well as
early ones.

A teacher run streams through ``Fastgen.generate_cuda(chunk=...)`` (on a
CUDA device one launch of the AR kernel a chunk) in bf16, calibration-free
W8A8 (``int8``) or W8A8 static (``int8_static``, calibrated on the first
second of the held-out audio); a student run through
``parallelgen.StudentStreamer`` (the flow kernel).

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.longform_check --ckpt_dir <run> \\
        [--seconds 12] [--chunk 4000] [--weight_dtype bf16|int8|int8_static] \\
        [--out_dir DIR] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.data.synthetic import make_speechlike_utterance
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.utils.quality import mcd

SR = 16000
SEED = 99  # disjoint from the smoke's training corpus
N_UTTS = 8
STUDENT_TILE = 256


def held_out_wavs(seconds):
    """The held-out long utterances [N_UTTS, seconds * SR]."""
    rng = np.random.default_rng(SEED)
    return np.stack([make_speechlike_utterance(rng, SR, float(seconds)) for _ in range(N_UTTS)])


def window_metrics(audio, wavs):
    """Matched mel corr and MCD of each row's 1-second windows against the
    source's: two arrays [rows, windows]."""
    L = min(audio.shape[1], wavs.shape[1])
    n_win = L // SR
    win_corr = np.zeros((len(wavs), n_win))
    win_mcd = np.zeros((len(wavs), n_win))
    for i in range(len(wavs)):
        for w in range(n_win):
            gen_mel = stft_ops.melspectrogram_np(audio[i, w * SR : (w + 1) * SR])
            n = gen_mel.shape[0]
            ref_mel = stft_ops.melspectrogram_np(wavs[i, w * SR : (w + 1) * SR])[:n]
            win_corr[i, w] = np.corrcoef(gen_mel.ravel(), ref_mel.ravel())[0, 1]
            win_mcd[i, w] = mcd(gen_mel, ref_mel)
    return win_corr, win_mcd


def decay_gate(per_win, per_win_mcd):
    """Late windows must keep tracking: no collapse (absolute floor) and no
    substantial decay vs the start of the utterance, on BOTH the correlation
    and the spectral (MCD) axis (correlation alone can miss spectral
    artifacts that grow over a long stream).  Returns the early / late means
    of the first and last third of the windows and the verdict."""
    k = max(len(per_win) // 3, 1)
    early, late = float(per_win[:k].mean()), float(per_win[-k:].mean())
    mcd_early, mcd_late = float(per_win_mcd[:k].mean()), float(per_win_mcd[-k:].mean())
    ok = late > 0.3 and late > early - 0.15 and mcd_late < mcd_early * 1.25
    return {"early": early, "late": late, "mcd_early": mcd_early, "mcd_late": mcd_late, "ok": ok}


def synthesize(ckpt_dir, wavs, chunk, weight_dtype, device):
    """(audio [N_UTTS, L] numpy, mode label, the chunk served) of a run
    directory on the held-out wavs, streamed in chunks."""
    from nsynth_wavenet_tpu_torch import evaluation

    cfg, params = evaluation.load_eval_model(ckpt_dir, device=device)
    mel = torch.from_numpy(stft_ops.melspectrogram_np(wavs)).to(device)
    if isinstance(cfg, config_lib.ParallelWavenetConfig):
        from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
        from nsynth_wavenet_tpu_torch.models.parallelgen import StudentStreamer

        # the JAX tool rounds the chunk up to its kernel's 256-row tile; the
        # port's kernel takes any chunk, and the rounding is kept so that
        # both tools stream the same chunks
        chunk = -(-chunk // STUDENT_TILE) * STUDENT_TILE
        streamer = StudentStreamer(ParallelWavenet(cfg), chunk=chunk)
        audio = streamer.synthesize(params, mel, torch.Generator().manual_seed(0))
        return audio.cpu().numpy(), "student-flow", chunk

    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet

    fg = Fastgen(Wavenet(cfg))
    act_amax = None
    if weight_dtype == "int8_static":
        cal = wavs[:, :SR]  # 1 s calibration slice of the held-out audio
        act_amax = fg.calibrate_act_amax(
            params, torch.from_numpy(cal).to(device),
            torch.from_numpy(stft_ops.melspectrogram_np(cal)).to(device))
    audio = fg.generate_cuda(params, mel, seed=0,
                             weight_dtype="bf16" if weight_dtype == "bf16" else "int8",
                             chunk=chunk, act_amax=act_amax, gate_static=act_amax is not None)
    return audio.cpu().numpy(), weight_dtype, chunk


def longform(ckpt_dir, seconds, chunk, weight_dtype, out_dir, device="cuda"):
    """Synthesize, write the wavs, print the per-window report and the gate;
    returns the readings with 'passed'."""
    wavs = held_out_wavs(seconds)
    audio, label, chunk = synthesize(ckpt_dir, wavs, chunk, weight_dtype, device)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(wavs)):
        wav_io.write_wav(os.path.join(out_dir, f"longform_{label}_{i}.wav"), audio[i])
    win_corr, win_mcd = window_metrics(audio, wavs)
    per_win, per_win_mcd = win_corr.mean(axis=0), win_mcd.mean(axis=0)
    print("per-window matched mel corr:", " ".join(f"{c:.3f}" for c in per_win))
    print("per-window MCD (dB):       ", " ".join(f"{c:.1f}" for c in per_win_mcd))
    g = decay_gate(per_win, per_win_mcd)
    print(f"early {g['early']:.3f} late {g['late']:.3f}; "
          f"mcd early {g['mcd_early']:.1f} late {g['mcd_late']:.1f} dB -> "
          f"{'PASS' if g['ok'] else 'FAIL'} ({label}, {seconds}s, chunk {chunk})")
    return {"mode": label, "chunk": chunk, "samples": audio.shape[1], "audio": audio,
            "per_window_corr": per_win.tolist(), "per_window_mcd": per_win_mcd.tolist(),
            "passed": g["ok"], **g}


def main(ckpt_dir, seconds, chunk, weight_dtype, out_dir, device="cuda"):
    return 0 if longform(ckpt_dir, seconds, chunk, weight_dtype, out_dir, device)["passed"] else 1


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--seconds", default=12, type=int)
    ap.add_argument("--chunk", default=4000, type=int)
    ap.add_argument("--weight_dtype", default="bf16", choices=["bf16", "int8", "int8_static"])
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "longform_check_torch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return main(args.ckpt_dir, args.seconds, args.chunk, args.weight_dtype, args.out_dir,
                args.device)


if __name__ == "__main__":
    sys.exit(cli())
