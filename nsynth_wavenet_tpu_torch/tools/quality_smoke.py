"""End-to-end learning-quality smoke on the port (counterpart of the JAX
package's tools/quality_smoke.py): train a small teacher on synthetic audio
with the port's runner, synthesize from held-out mels, and check that the
generated audio's spectral content follows the conditioning.

The corpora (--corpus):

* ``tones`` (default): stationary harmonic tones.  Pass criteria: (1)
  training loss far below uniform, (2) held-out teacher-forced loss far below
  uniform, (3) free-running generation strongly tonal (low spectral
  flatness) with mel correlation above chance.  On perfectly periodic tones
  the AR context alone determines the next sample, so a WaveNet learns to
  ignore the (redundant) mel: free-running pitch need not track the
  conditioning on this corpus.

* ``speech``: formant-synthesized pseudo-speech (data/synthetic.py) whose
  random segment sequences make the mel informative.  Criteria (2)/(3)
  become conditioning-usage gates: the held-out teacher-forced loss must be
  markedly lower with the MATCHED mel than with a shuffled one (cond gap),
  and free-running audio must correlate with its own conditioning mel more
  than with the other utterances' mels.

* ``speech_84d3f9e`` (the functions only; gauss_pairing --corpus): the
  earlier, plainer pseudo-speech corpus and held-out clips of the JAX
  package's passing Gauss student smoke (tools/speech_corpus_84d3f9e.py),
  under the ``speech`` gates.

The main free run goes through the plain ``Fastgen.generate`` (the JAX tool's
runs through XLA's ``generate``); ``--compare_cuda`` (the JAX tool's
``--compare_pallas``) also serves the trained weights through
``Fastgen.generate_cuda`` in bf16, calibration-free W8A8 and W8A8 static,
and holds each to the same gate: on a CUDA device that is the hand-written
AR kernel, one launch a call.  ``--student`` runs the distillation smoke:
teacher -> IAF student -> one-shot synthesis (the plain
``parallelgen.synthesize``, as the JAX tool's ``jit_synthesize`` is plain
XLA) from held-out mels.

Every threshold is the JAX tool's.  Each gate's arithmetic is a function that
returns its readings and booleans; ``teacher_smoke`` / ``student_smoke``
return them all, and ``main`` / ``main_student`` print the JAX tool's report
lines and map the result to an exit code.

Left out: the JAX tool's ``--corpus real`` (``main_real``) overfits the
reference's real LJSpeech clip (the reference's tests/test_data/test.wav),
which is not in this repository; it waits until the clip is.

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.quality_smoke [--steps 30000]
        [--corpus tones|speech] [--head ce|mol|gauss] [--compare_cuda]
        [--student [--pairing gauss|mol]] [--out_dir DIR] [--device cpu]
"""

import argparse
import json
import os
import re
import sys
import tempfile

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch.data import dataset as data_lib
from nsynth_wavenet_tpu_torch.data import synthetic
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.tools import speech_corpus_84d3f9e
from nsynth_wavenet_tpu_torch.utils import quality
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

# dropout_inputs is the reference's own trick for forcing mel reliance
# (wavenet_mol.json sets it): on perfectly AR-predictable tonal data a
# WaveNet otherwise ignores the conditioning entirely (verified: without
# it, teacher-forced loss is flat across matched/mismatched mels).
TEACHER_CFG = {
    "wave_length": 3840,
    "num_layers": 10,
    "num_stages": 5,
    "filter_length": 3,
    "width": 128,
    "skip_width": 128,
    "deconv_width": 128,
    "deconv_config": [[40, 10], [80, 20]],
    "use_mu_law": True,
    "loss_type": "ce",
    "dropout_inputs": True,
    "num_iters": 3000,
}

# Student-smoke pairings (reference asserts these, parallel_wavenet.py:146-151):
# gauss: Gaussian teacher + Gaussian student (ClariNet closed-form KL,
#        reference parallel_wavenet.py:404-428) — the cheapest path;
# mol:   MoL teacher + logistic student (Monte-Carlo KL with num_samples
#        draws, reference parallel_wavenet.py:361-402).
GAUSS_TEACHER_CFG = dict(TEACHER_CFG, loss_type="gauss", use_mu_law=False)
# the MoL teacher is the reference's finicky one: wavenet_mol.json gives it
# a LOWER lr schedule (1e-4 start vs the 2e-4 default) and 2x the iters —
# at 2e-4 it plateaus fitting the marginal and never picks up the mel
# (measured: cond_gap ~0.005 after 30k steps on the speech corpus)
MOL_TEACHER_CFG = dict(
    TEACHER_CFG,
    loss_type="mol",
    use_mu_law=False,
    lr_schedule=[[0, 1e-4], [90000, 6e-5], [120000, 4e-5], [150000, 2e-5],
                 [180000, 6e-6], [210000, 2e-6]],
)

STUDENT_CFG = {
    "wave_length": 3840,
    "num_iaf_layers": [5, 5],
    "num_stages": 5,
    "filter_length": 3,
    "width": 64,
    "deconv_width": 128,
    "deconv_config": [[40, 10], [80, 20]],
    "use_mu_law": False,
    "loss_type": "gauss",
    "power_loss_factor": 1.0,
    "use_weight_norm": False,
    "num_iters": 30000,
}

SR = 16000
PITCHES = [110, 150, 200, 270]
TEACHER_BATCH = 8
STUDENT_BATCH = 4
HELD_OUT_SEED = 1234  # disjoint from the training corpus's seed
N_HELD_OUT = 4
HELD_OUT_SAMPLES = SR  # 1 s held-out clips
STUDENT_SEED = 7  # the one-shot synthesis's noise
# speech-like corpora (the conditioning-usage gates), by name: the generator
# module of the training corpus and of the held-out clips
SPEECH_CORPORA = {"speech": synthetic, "speech_84d3f9e": speech_corpus_84d3f9e}
# (label, generate_cuda weight_dtype, calibrated static scales) of --compare_cuda
CUDA_MODES = (("cuda-bf16", "bf16", False),
              ("cuda-int8", "int8", False),
              ("cuda-int8s", "int8", True))  # static act+gate scales


def head_cfg(head):
    """The teacher config of an output head."""
    return {"ce": TEACHER_CFG, "mol": MOL_TEACHER_CFG, "gauss": GAUSS_TEACHER_CFG}[head]


# ---- corpora -------------------------------------------------------------------


def make_corpus(out_dir, sr=SR, seed=0):
    """The tones corpus: 16 two-second harmonic tones at four pitches.
    Returns (the dataset index, the pitches)."""
    rng = np.random.default_rng(seed)
    waves, ids = [], []
    t = np.arange(2 * sr) / sr
    pitches = list(PITCHES)
    for i, f0 in enumerate(pitches * 4):
        amp = 0.45 * (0.7 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 3) * t))
        w = amp * (
            np.sin(2 * np.pi * f0 * t)
            + 0.5 * np.sin(2 * np.pi * 2 * f0 * t)
            + 0.2 * np.sin(2 * np.pi * 3 * f0 * t)
        )
        waves.append(np.clip(w + 0.005 * rng.standard_normal(len(t)), -0.99, 0.99).astype(np.float32))
        ids.append(f"tone_{i:02d}_f{f0}")
    return data_lib.build_dataset_from_arrays(waves, ids, out_dir), pitches


def make_speech_corpus(out_dir, seed=0, n_utts=24, corpus="speech"):
    """The dataset of ``n_utts`` two-second utterances of a SPEECH_CORPORA
    corpus from ``seed``."""
    waves, ids = SPEECH_CORPORA[corpus].make_speechlike_corpus(n_utts=n_utts, duration=2.0,
                                                               seed=seed)
    return data_lib.build_dataset_from_arrays(waves, ids, out_dir)


def held_out_wavs(corpus):
    """The held-out clips [N_HELD_OUT, HELD_OUT_SAMPLES] of main and
    main_student: speech-like utterances of the corpus from HELD_OUT_SEED,
    or one clean tone a pitch."""
    if corpus in SPEECH_CORPORA:
        rng = np.random.default_rng(HELD_OUT_SEED)
        return np.stack([SPEECH_CORPORA[corpus].make_speechlike_utterance(
            rng, SR, HELD_OUT_SAMPLES / SR) for _ in range(N_HELD_OUT)])
    t = np.arange(HELD_OUT_SAMPLES) / SR
    return np.stack(
        [
            0.4
            * (
                np.sin(2 * np.pi * f0 * t)
                + 0.5 * np.sin(2 * np.pi * 2 * f0 * t)
                + 0.2 * np.sin(2 * np.pi * 3 * f0 * t)
            )
            for f0 in PITCHES
        ]
    ).astype(np.float32)


# ---- metrics -------------------------------------------------------------------


def mel_track_metrics(audio, mels, n_samples, out_dir=None, wav_prefix=None):
    """{'corr', 'msd', 'mcd': (matched mean, mismatched mean)} of each clip's
    first n_samples against every conditioning mel (utils/quality.py);
    optionally writes the clips as {out_dir}/{wav_prefix}_{i}.wav."""
    if out_dir is not None:
        for i in range(len(mels)):
            wav_io.write_wav(os.path.join(out_dir, f"{wav_prefix}_{i}.wav"), audio[i])
    return quality.mel_track_metrics(audio, mels, n_samples)


def mel_track_corr(audio, mels, n_samples, out_dir=None, wav_prefix=None):
    """Correlation-only view of mel_track_metrics."""
    return mel_track_metrics(audio, mels, n_samples, out_dir=out_dir, wav_prefix=wav_prefix)["corr"]


def dominant_freq(wav, sr=SR):
    spec = np.abs(np.fft.rfft(wav * np.hanning(len(wav))))
    freqs = np.fft.rfftfreq(len(wav), 1 / sr)
    lo = freqs > 60
    return freqs[lo][np.argmax(spec[lo])]


def spectral_flatness(gen):
    """Geometric over arithmetic mean of the magnitude spectrum after the
    first 2000 samples (1 for white noise, near 0 for a pure tone)."""
    spec = np.abs(np.fft.rfft(gen[2000:] * np.hanning(len(gen) - 2000))) + 1e-9
    return float(np.exp(np.mean(np.log(spec))) / np.mean(spec))


def parse_teacher_log(run_dir):
    """The training losses of a teacher run's train.log, in order."""
    losses = []
    with open(os.path.join(run_dir, "train.log")) as f:
        for line in f:
            if " loss " in line:
                losses.append(float(line.split(" loss ")[1].split()[0]))
    return losses


def parse_student_log(run_dir, window=10):
    """Windowed-mean (loss, kl, power, hpt) at the start and end of the
    student log.  Per-batch student losses are extremely noisy at tiny batch
    sizes (a silence-heavy crop and a voiced crop differ by >5x in power
    loss), so single-row comparisons are meaningless — compare means over the
    first/last `window` logged rows instead."""
    pat = re.compile(
        r"step \d+ loss ([\d.eE+-]+) kl ([\d.eE+-]+) power ([\d.eE+-]+)"
        r"(?: hpt ([\d.eE+-]+))?"
    )
    rows = []
    with open(os.path.join(run_dir, "train.log")) as f:
        for line in f:
            m = pat.search(line)
            if m:
                rows.append(tuple(float(g) if g is not None else float("nan")
                                  for g in m.groups()))
    if not rows:
        raise ValueError(f"no student loss lines in {run_dir}/train.log")
    w = min(window, max(len(rows) // 2, 1))
    head = tuple(float(np.mean([r[k] for r in rows[:w]])) for k in range(4))
    tail = tuple(float(np.mean([r[k] for r in rows[-w:]])) for k in range(4))
    return head, tail


@torch.no_grad()
def teacher_forced_losses(model, params, wavs, mel):
    """(matched, shuffled) held-out teacher-forced loss of Wavenet.forward_loss
    on the first wave_length samples of the clips wavs [B, N] (numpy) and the
    mel frames that cover them, the shuffled one with the mel rolled by one
    utterance."""
    from nsynth_wavenet_tpu_torch.models.wavenet import no_tf32

    cfg = model.cfg
    device = tree_lib.leaves(params)[0].device
    wav_crop = torch.from_numpy(np.ascontiguousarray(wavs[:, : cfg.wave_length], np.float32))
    mel_crop = mel[:, : cfg.wave_length // 200 + 1]
    with no_tf32():
        def loss(m):
            m = torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)
            return float(model.forward_loss(params, wav_crop.to(device), m)["loss"])

        return loss(mel_crop), loss(np.roll(mel_crop, 1, axis=0))


# ---- gates ---------------------------------------------------------------------


def loss_gate(losses, head, corpus):
    """Criterion 1: training learned the audio distribution.  CE: absolute
    thresholds in nats against the uniform log(256) ceiling.  mol/gauss:
    continuous NLL with no comparable absolute scale -> gate on substantial
    improvement over the first logged loss instead."""
    final = losses[-1] if losses else None
    if head == "ce":
        # pseudo-speech is a harder distribution (noise bursts are near the
        # entropy ceiling); thresholds calibrated per corpus, both far below
        # the uniform 5.55 nats
        thresh = 4.0 if corpus in SPEECH_CORPORA else 2.5
        ok = final is not None and final < thresh
    else:
        ok = final is not None and final < losses[0] - 1.0
    return {"first_loss": losses[0] if losses else None, "final_loss": final, "ok": ok}


def tf_gate(tf_loss, final_loss, head, corpus):
    """Criterion 2: held-out teacher-forced prediction, absolute for CE,
    no-blowup vs the training loss for the continuous heads."""
    if head == "ce":
        ok = tf_loss < (4.5 if corpus in SPEECH_CORPORA else 3.0)
    else:
        ok = final_loss is not None and tf_loss < final_loss + 0.5
    return {"tf_loss": tf_loss, "ok": ok}


def cond_gate(tf_loss, tf_mis, head):
    """Criterion 3(a) on the speech corpus: the teacher-forced loss must be
    markedly worse under a shuffled mel."""
    cond_gap = tf_mis - tf_loss
    # the 0.15-nat gap threshold is calibrated on the CE head; the
    # continuous NLLs sit on a different scale (measured: a gauss teacher
    # with clearly-tracking free-run audio shows ~0.14), so for them the
    # gap gate is a looser sanity floor and the tracking gate decides
    gap_thresh = 0.15 if head == "ce" else 0.05
    return {"tf_mis": tf_mis, "cond_gap": cond_gap, "ok": cond_gap > gap_thresh}


def tracking_gate(mt):
    """Criterion 3(b) on the speech corpus: free-running audio tracks its OWN
    mel more than the others' by correlation (+0.05), RMS mel distance and
    MCD.  mt: mel_track_metrics."""
    m_corr, mm_corr = mt["corr"]
    return (m_corr > mm_corr + 0.05
            and mt["msd"][0] < mt["msd"][1]
            and mt["mcd"][0] < mt["mcd"][1])


def kernel_tracking_gate(pmc, pmmc, m_corr):
    """A serving kernel on the trained weights (speech): its free run tracks
    (+0.05 over mismatched) and stays within 0.1 of the plain run's matched
    corr."""
    return pmc > pmmc + 0.05 and pmc > m_corr - 0.1


def tonal_gate(flatnesses, corrs):
    """Criterion 3 on the tones corpus.  An undertrained-but-working AR
    sampler produces noisy tones (flatness ~0.35 at 30k steps on this
    corpus); a broken sampler produces white noise (flatness ~1.0).  Full
    fidelity needs reference-scale training (200k steps on a real corpus)."""
    median_flat = float(np.median(flatnesses))
    mean_corr = float(np.mean(corrs))
    tonal_ok = median_flat < 0.45
    return {"median_flatness": median_flat, "mean_corr": mean_corr, "tonal_ok": tonal_ok,
            "ok": tonal_ok and mean_corr > 0.4}


def kernel_tonal_gate(flatnesses, corrs, base_median):
    """A serving kernel on the tones corpus: median flatness within 0.1 of the
    plain run's and mean mel corr over 0.4."""
    med_flat, mean_c = float(np.median(flatnesses)), float(np.mean(corrs))
    return {"median_flatness": med_flat, "mean_corr": mean_c,
            "ok": med_flat < base_median + 0.1 and mean_c > 0.4}


def student_loss_gate(head, tail, pairing, steps):
    """Gate (1) of the student smoke on parse_student_log's windows: KL and
    power loss decrease (gauss), or no KL blow-up and a halving power loss
    (mol; H_Ps_Pt must decrease at >= 60k steps)."""
    (l0, kl0, pw0, hpt0), (l1, kl1, pw1, hpt1) = head, tail
    hpt_ok = None
    if pairing == "gauss":
        kl_ok = kl1 < kl0 * 0.5
        pw_ok = pw1 < pw0 * 0.5
    else:
        # The MC logistic KL's floor is the teacher's own NLL: H_Ps_Pt >=
        # teacher cross-entropy (~6.7 nats for a 30k-step MoL teacher on
        # this corpus) while H_Ps = mean(log_scale_tot)+2 ~ -0.5, so KL
        # cannot fall much below ~7 at smoke scale no matter how good the
        # student — and it can even RISE while the joint objective improves,
        # because power-loss sharpening lowers the student entropy term.
        # (Measured: KL flat at ~10.7-11.0 over 30k steps while power
        # halves and free-run tracking reaches 0.71.)  Gate on no-blowup
        # instead; power keeps a halving gate with a small tolerance.
        kl_ok = kl1 < kl0 * 1.2
        pw_ok = pw1 < pw0 * 0.55
        # H_Ps_Pt (the teacher cross-entropy term) is the KL component that
        # CAN move: the KL itself is floored by the teacher's own NLL while
        # power-loss sharpening lowers H_Ps in lockstep (reference
        # parallel_wavenet.py:361-402).  At long-run scale (>= 60k steps)
        # require it to actually DECREASE.  At smoke scale it is
        # informational (windowed means at 30k are inside the per-batch
        # noise).
        if steps >= 60000 and np.isfinite(hpt0) and np.isfinite(hpt1):
            hpt_ok = hpt1 < hpt0 - 0.1
            kl_ok = kl_ok and hpt_ok
    return {"loss": (l0, l1), "kl": (kl0, kl1), "power": (pw0, pw1), "hpt": (hpt0, hpt1),
            "kl_ok": kl_ok, "pw_ok": pw_ok, "hpt_ok": hpt_ok}


def student_amp_gate(audio):
    """Gate (2): sane amplitude statistics (no scale collapse/explosion)."""
    std = float(np.std(audio))
    return {"std": std, "ok": bool(np.isfinite(audio).all()) and 0.01 < std < 1.0}


def student_tracking_gate(mt, corpus):
    """Gate (3): on the speech corpus the student tracks its own mel (+0.05)
    and is spectrally CLOSER to it than to the others (RMS mel distance and
    MCD; correlation alone can miss spectral artifacts); on tones a mel corr
    over 0.4."""
    m_corr, mm_corr = mt["corr"]
    if corpus in SPEECH_CORPORA:
        spec_ok = (mt["msd"][0] < mt["msd"][1]) and (mt["mcd"][0] < mt["mcd"][1])
        return m_corr > mm_corr + 0.05 and spec_ok
    return m_corr > 0.4


# ---- the smokes ----------------------------------------------------------------


def _write_config(path, cfg):
    with open(path, "wt") as f:
        json.dump(cfg, f)
    return path


def _build_corpus(ds_dir, corpus, n_utts):
    if corpus in SPEECH_CORPORA:
        make_speech_corpus(ds_dir, n_utts=n_utts, corpus=corpus)
    else:
        make_corpus(ds_dir)


def _counted(fn):
    """(fn(), the AR kernel's CUDA launches by name that fn enqueued), from the
    counts fastgen_kernel.generate keeps (they move only on a CUDA device)."""
    from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

    before = dict(fk.generate.kernel_launches)
    out = fn()
    launched = {k: n - before.get(k, 0) for k, n in fk.generate.kernel_launches.items()}
    return out, {k: n for k, n in launched.items() if n}


def _cuda_runs(fg, params, wavs, mel, device):
    """Fastgen.generate_cuda in each of CUDA_MODES on the held-out mels tiled
    to 8 rows, seed 0.  The JAX tool tiles because its kernel needs
    B % 8 == 0; the port's kernel takes any B, and the tiling is kept so that
    the gate reads the same rows.  Yields (label, audio [len(wavs), L],
    launches)."""
    rep = 8 // mel.shape[0]
    mel_rep = torch.from_numpy(np.tile(mel, (rep, 1, 1))).to(device)
    amax = fg.calibrate_act_amax(params, torch.from_numpy(wavs).to(device),
                                 torch.from_numpy(mel).to(device))
    for label, wd, static in CUDA_MODES:
        am = amax if static else None
        audio, launches = _counted(lambda: fg.generate_cuda(
            params, mel_rep, seed=0, weight_dtype=wd, act_amax=am, gate_static=am is not None))
        yield label, audio.cpu().numpy()[: len(wavs)], launches


def teacher_smoke(steps, out_dir, corpus="tones", head="ce", n_utts=24, compare_cuda=False,
                  device="cuda"):
    """Train the head's teacher for ``steps`` steps on the corpus, free-run it
    from held-out mels and apply the gates, printing the JAX tool's report
    lines.  Returns every reading, each gate's boolean under 'gates',
    'passed', the run directory, the held-out mels and the free-run audio
    ('audio'; under 'cuda' each mode's audio, metrics, gate and launches)."""
    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.training import runner

    os.makedirs(out_dir, exist_ok=True)
    ds_dir = os.path.join(out_dir, "ds")
    _build_corpus(ds_dir, corpus, n_utts)

    # head selects the teacher output distribution: the CE thresholds are in
    # nats against the uniform log(256) ceiling; the continuous heads
    # (mol/gauss) have no comparable absolute scale, so for them the
    # absolute-loss gates become improvement gates and the (relative)
    # conditioning gates carry the check.  This matters for --compare_cuda:
    # each head has its OWN in-kernel sampler (gumbel-argmax CE, logistic
    # MoL, Box-Muller gauss), and only a free-running quality gate exercises
    # a sampler end to end.
    cfg_path = _write_config(os.path.join(out_dir, "teacher.json"),
                             dict(head_cfg(head), num_iters=steps))
    run_dir, state = runner.train_wavenet(
        train_path=ds_dir, config_path=cfg_path, log_root=os.path.join(out_dir, "runs"),
        total_batch_size=TEACHER_BATCH, num_steps=steps, ckpt_every_steps=max(steps, 1),
        device=device)

    model = Wavenet(config_lib.load_config(cfg_path))
    params = state["ema"]
    fg = Fastgen(model)
    wavs = held_out_wavs(corpus)
    mel = stft_ops.melspectrogram_np(wavs)
    audio = fg.generate(params, torch.from_numpy(mel).to(device),
                        torch.Generator().manual_seed(0)).cpu().numpy()
    n = HELD_OUT_SAMPLES
    res = {"run_dir": run_dir, "corpus": corpus, "head": head, "steps": steps, "mel": mel,
           "audio": audio, "losses": parse_teacher_log(run_dir), "gates": {}}

    lg = loss_gate(res["losses"], head, corpus)
    res.update(first_loss=lg["first_loss"], final_loss=lg["final_loss"])
    res["gates"]["loss"] = lg["ok"]
    if head == "ce":
        print(f"final training loss {lg['final_loss']} (uniform {np.log(256):.2f}) -> {lg['ok']}")
    else:
        print(f"training loss {lg['first_loss']} -> {lg['final_loss']} "
              f"({head} NLL, improvement gate) -> {lg['ok']}")

    tf_loss, tf_mis = teacher_forced_losses(model, params, wavs, mel)
    tg = tf_gate(tf_loss, lg["final_loss"], head, corpus)
    res["tf_loss"], res["gates"]["tf"] = tf_loss, tg["ok"]
    print(f"held-out teacher-forced loss {tf_loss:.3f} -> {tg['ok']}")

    if corpus in SPEECH_CORPORA:
        cg = cond_gate(tf_loss, tf_mis, head)
        mt = mel_track_metrics(audio, mel, n, out_dir=out_dir, wav_prefix="gen_speech")
        res.update(tf_mis=tf_mis, cond_gap=cg["cond_gap"], metrics=mt)
        res["gates"]["cond"], res["gates"]["track"] = cg["ok"], tracking_gate(mt)
        m_corr, mm_corr = mt["corr"]
        print(f"cond gap (shuffled-mel TF loss {tf_mis:.3f} - matched) "
              f"{cg['cond_gap']:.3f} -> {cg['ok']}")
        print(f"free-run mel corr matched {m_corr:.3f} vs mismatched "
              f"{mm_corr:.3f}; msd {mt['msd'][0]:.3f} vs {mt['msd'][1]:.3f}; "
              f"mcd {mt['mcd'][0]:.1f} vs {mt['mcd'][1]:.1f} dB -> {res['gates']['track']}")
        if compare_cuda:
            # the serving kernels must pass the SAME conditioning-tracking
            # gate on the trained weights: a subtly broken conditioning
            # operand (enc fill, cond concat, quantization) shows up
            # directly as lost tracking
            res["cuda"] = {}
            for label, audio_p, launches in _cuda_runs(fg, params, wavs, mel, device):
                pmt = mel_track_metrics(audio_p, mel, n, out_dir=out_dir,
                                        wav_prefix=f"gen_{label}")
                pmc, pmmc = pmt["corr"]
                ok = kernel_tracking_gate(pmc, pmmc, m_corr)
                res["cuda"][label] = {"audio": audio_p, "metrics": pmt, "ok": ok,
                                      "launches": launches}
                res["gates"][label] = ok
                print(f"{label}: free-run mel corr matched {pmc:.3f} vs "
                      f"mismatched {pmmc:.3f} (plain matched {m_corr:.3f}) -> {ok}")
        res["passed"] = all(res["gates"].values())
        print("QUALITY SMOKE (speech):", "PASS" if res["passed"] else "FAIL")
        return res

    # free-running generation produces structured (tonal) audio, not noise
    flats, corrs = [], []
    for i, f0 in enumerate(PITCHES):
        gen = audio[i]
        wav_io.write_wav(os.path.join(out_dir, f"gen_f{f0}.wav"), gen)
        got_f = dominant_freq(gen[2000:])
        flats.append(spectral_flatness(gen))
        gen_mel = stft_ops.melspectrogram_np(gen[:n])
        corrs.append(np.corrcoef(gen_mel.ravel(), mel[i, : gen_mel.shape[0]].ravel())[0, 1])
        print(f"pitch {f0:4d} Hz -> generated dominant {got_f:7.1f} Hz, "
              f"spectral flatness {flats[-1]:.4f}, mel corr {corrs[-1]:.3f}")
    tn = tonal_gate(flats, corrs)
    res.update(flatness=flats, mel_corrs=[float(c) for c in corrs],
               median_flatness=tn["median_flatness"], mean_corr=tn["mean_corr"])
    res["gates"]["tonal"] = tn["ok"]
    print(f"tonal {tn['tonal_ok']}; mean mel corr {tn['mean_corr']:.3f} (informational: on "
          "perfectly AR-predictable tones the conditioning is informationally "
          "redundant, so free-running pitch need not track the mel — see "
          "module docstring; real-speech corpora do not have this property)")

    if compare_cuda:
        # the serving kernels on the TRAINED model must match the plain
        # sampler's audio quality metrics: int8 quantization on real weights
        res["cuda"] = {}
        for label, audio_p, launches in _cuda_runs(fg, params, wavs, mel, device):
            kf, kc = [], []
            for i, f0 in enumerate(PITCHES):
                gen = audio_p[i][:n]
                wav_io.write_wav(os.path.join(out_dir, f"gen_{label}_f{f0}.wav"), gen)
                kf.append(spectral_flatness(gen))
                gen_mel = stft_ops.melspectrogram_np(gen)
                kc.append(float(np.corrcoef(gen_mel.ravel(),
                                            mel[i, : gen_mel.shape[0]].ravel())[0, 1]))
            kg = kernel_tonal_gate(kf, kc, tn["median_flatness"])
            res["cuda"][label] = {"audio": audio_p, "ok": kg["ok"], "launches": launches, **kg}
            res["gates"][label] = kg["ok"]
            print(f"{label}: median flatness {kg['median_flatness']:.4f} (plain "
                  f"{tn['median_flatness']:.4f}), mean mel corr {kg['mean_corr']:.3f} -> {kg['ok']}")
    res["passed"] = all(res["gates"].values())
    print("QUALITY SMOKE:", "PASS" if res["passed"] else "FAIL")
    return res


def main(steps, out_dir, corpus="tones", head="ce", n_utts=24, compare_cuda=False,
         device="cuda"):
    return 0 if teacher_smoke(steps, out_dir, corpus, head, n_utts, compare_cuda,
                              device)["passed"] else 1


def student_smoke(steps, out_dir, corpus, pairing="gauss", n_utts=24, device="cuda"):
    """Distillation-quality smoke: teacher -> IAF student -> one-shot
    synthesis from held-out mels.  pairing='gauss' (ClariNet closed-form KL)
    or 'mol' (MoL teacher + logistic student, Monte-Carlo KL).  Gates:
    (1) KL and power loss both decrease substantially over training,
    (2) generated audio has sane amplitude statistics (no scale
    collapse/explosion), (3) on the speech corpus the free-running student
    tracks its own conditioning mel better than the other utterances'.
    Returns the readings, the gates' booleans, 'passed', both run directories
    and the audio."""
    from nsynth_wavenet_tpu_torch.training import runner

    os.makedirs(out_dir, exist_ok=True)
    ds_dir = os.path.join(out_dir, "ds")
    _build_corpus(ds_dir, corpus, n_utts)

    te_cfg = GAUSS_TEACHER_CFG if pairing == "gauss" else MOL_TEACHER_CFG
    te_cfg_path = _write_config(os.path.join(out_dir, f"teacher_{pairing}.json"),
                                dict(te_cfg, num_iters=steps))
    te_dir, _ = runner.train_wavenet(
        train_path=ds_dir, config_path=te_cfg_path, log_root=os.path.join(out_dir, "runs"),
        total_batch_size=TEACHER_BATCH, num_steps=steps, ckpt_every_steps=max(steps, 1),
        device=device)
    return distill_and_gate(te_dir, ds_dir, out_dir, corpus, pairing, steps, device)


def distill_and_gate(te_dir, ds_dir, out_dir, corpus, pairing, steps, device="cuda", seed=0,
                     tag=None, kl_sigma_floor=0.0, compute_dtype=None):
    """The student half of student_smoke: distil the smoke's student (its
    config with ``kl_sigma_floor``, and ``compute_dtype`` when given) for
    ``steps`` steps at ``seed`` from the teacher run directory ``te_dir`` on
    the dataset ``ds_dir``, synthesize from the held-out mels and apply the
    gates, printing the JAX tool's report lines.  Its run goes under
    <out_dir>/runs (<out_dir>/runs_<tag> with a tag: runs started in the
    same second are named alike), its config json and wavs under out_dir,
    named by ``tag`` (default the pairing)."""
    from nsynth_wavenet_tpu_torch import evaluation
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.training import runner

    tag = tag or pairing
    st_cfg = dict(STUDENT_CFG, num_iters=steps, kl_sigma_floor=kl_sigma_floor)
    if compute_dtype:
        st_cfg["compute_dtype"] = compute_dtype
    if pairing == "mol":
        st_cfg["loss_type"] = "logistic"
        st_cfg["num_samples"] = 100  # reference MC-KL draw count
    st_cfg_path = _write_config(os.path.join(out_dir, f"student_{tag}.json"), st_cfg)
    st_dir, _ = runner.train_parallel_wavenet(
        train_path=ds_dir, teacher_dir=te_dir, config_path=st_cfg_path,
        log_root=os.path.join(out_dir, "runs" if tag == pairing else f"runs_{tag}"),
        total_batch_size=STUDENT_BATCH, num_steps=steps, ckpt_every_steps=max(steps, 1),
        seed=seed, device=device)

    head, tail = parse_student_log(st_dir)
    lg = student_loss_gate(head, tail, pairing, steps)
    res = {"teacher_dir": te_dir, "run_dir": st_dir, "corpus": corpus, "pairing": pairing,
           "steps": steps, "log_head": head, "log_tail": tail,
           "gates": {"kl": lg["kl_ok"], "power": lg["pw_ok"]}}
    (kl0, kl1), (pw0, pw1), (hpt0, hpt1) = lg["kl"], lg["power"], lg["hpt"]
    if lg["hpt_ok"] is not None:
        print(f"student H_Ps_Pt {hpt0:.3f} -> {hpt1:.3f} (decreasing gate) -> {lg['hpt_ok']}")
    elif pairing != "gauss" and np.isfinite(hpt1):
        print(f"student H_Ps_Pt {hpt0:.3f} -> {hpt1:.3f} (informational "
              "at smoke scale; gated at >= 60k steps)")
    print(f"student kl {kl0:.3f} -> {kl1:.3f} ({lg['kl_ok']}); "
          f"power {pw0:.3f} -> {pw1:.3f} ({lg['pw_ok']}); "
          f"loss {lg['loss'][0]:.3f} -> {lg['loss'][1]:.3f}")

    # held-out one-shot synthesis
    wavs = held_out_wavs(corpus)
    mel = stft_ops.melspectrogram_np(wavs)
    cfg, params = evaluation.load_eval_model(st_dir, device=device)
    audio = parallelgen.synthesize(ParallelWavenet(cfg), params, torch.from_numpy(mel).to(device),
                                   torch.Generator().manual_seed(STUDENT_SEED)).cpu().numpy()
    amp = student_amp_gate(audio)
    res.update(mel=mel, audio=audio, std=amp["std"])
    res["gates"]["amp"] = amp["ok"]
    print(f"student free-run std {amp['std']:.4f} -> {amp['ok']}")

    mt = mel_track_metrics(audio, mel, HELD_OUT_SAMPLES, out_dir=out_dir,
                           wav_prefix="gen_student" if tag == pairing else f"gen_student_{tag}")
    res["metrics"] = mt
    res["gates"]["track"] = student_tracking_gate(mt, corpus)
    m_corr, mm_corr = mt["corr"]
    if corpus in SPEECH_CORPORA:
        print(f"student mel corr matched {m_corr:.3f} vs mismatched {mm_corr:.3f}; "
              f"msd {mt['msd'][0]:.3f} vs {mt['msd'][1]:.3f}; "
              f"mcd {mt['mcd'][0]:.1f} vs {mt['mcd'][1]:.1f} dB "
              f"-> {res['gates']['track']}")
    else:
        print(f"student mel corr {m_corr:.3f} -> {res['gates']['track']}")
    res["passed"] = all(res["gates"].values())
    print("QUALITY SMOKE (student):", "PASS" if res["passed"] else "FAIL")
    return res


def main_student(steps, out_dir, corpus, pairing="gauss", n_utts=24, device="cuda"):
    return 0 if student_smoke(steps, out_dir, corpus, pairing, n_utts, device)["passed"] else 1


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", default=30000, type=int)
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "quality_smoke_torch"))
    ap.add_argument("--corpus", default="tones", choices=["tones", "speech"],
                    help="'speech' = formant-synthesized pseudo-speech where "
                         "the mel is genuinely informative (conditioning-"
                         "usage gates); 'tones' = harmonic corpus (tonality "
                         "gates).  The JAX tool's 'real' needs the reference's "
                         "LJSpeech clip, which this repository does not hold")
    ap.add_argument("--compare_cuda", action="store_true",
                    help="also synthesize through Fastgen.generate_cuda in bf16, "
                         "W8A8 and W8A8 static and gate on their quality metrics "
                         "(tones: flatness compare; speech: conditioning-"
                         "tracking compare)")
    ap.add_argument("--student", action="store_true",
                    help="distillation smoke instead: teacher -> IAF "
                         "student -> one-shot synthesis gates")
    ap.add_argument("--pairing", default="gauss", choices=["gauss", "mol"],
                    help="student smoke pairing: 'gauss' = ClariNet "
                         "closed-form KL; 'mol' = MoL teacher + logistic "
                         "student with Monte-Carlo KL")
    ap.add_argument("--n_utts", default=24, type=int,
                    help="speech-corpus size; the default 24 shows train/"
                         "held-out gap at 100k steps (toy-corpus "
                         "specialization) -- raise for generalization runs")
    ap.add_argument("--head", default="ce", choices=["ce", "mol", "gauss"],
                    help="teacher output distribution; with --compare_cuda "
                         "this picks which in-kernel sampler (gumbel-argmax "
                         "CE / logistic MoL / Box-Muller gauss) gets the "
                         "free-running quality gate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.student:
        return main_student(args.steps, args.out_dir, args.corpus, args.pairing, args.n_utts,
                            args.device)
    return main(args.steps, args.out_dir, args.corpus, args.head, args.n_utts, args.compare_cuda,
                args.device)


if __name__ == "__main__":
    sys.exit(cli())
