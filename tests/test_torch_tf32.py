"""Every f32 path of the teacher, and the plain student synthesis, runs its
convolutions with TF32 off.

cuDNN runs an f32 convolution in TF32 unless told otherwise (PyTorch's
default), which parts from the reference by more than the parity tolerances.
Here both switches are set to True before each call, the port's conv1d and
trans_conv1d are wrapped to record the switches at the moment they run, and
every recorded call must see both off; the caller's settings must come back.
The flags are read on the CPU too, so this holds without a card.
"""

import os

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import generate_wavenet
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import stft
from tools.make_golden_ckpt import eval_mels, student_dir

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The step loops here are many tiny ops: one thread runs them as fast as
    many, and keeps this file's worker from fighting the other test workers'
    thread pools for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def recorded(monkeypatch):
    """Switch TF32 on, wrap the port's convolutions, yield the list of
    (cudnn.allow_tf32, matmul.allow_tf32) seen by each call."""
    seen = []
    for name in ("conv1d", "trans_conv1d"):
        orig = getattr(conv_ops, name)

        def wrapped(*args, _orig=orig, **kwargs):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return _orig(*args, **kwargs)

        monkeypatch.setattr(conv_ops, name, wrapped)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield seen
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True), \
        "the caller's TF32 settings did not come back"
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _teacher(head):
    d = os.path.join(GOLDEN, f"tiny_{head}")
    cfg = tconfig.load_config(os.path.join(d, "meta.json"))
    assert cfg.compute_dtype == "float32"
    return Wavenet(cfg), weights.load_npz(os.path.join(d, "params.npz"), device="cpu"), d


def _inputs(n=1280):
    mels, wav = eval_mels(n=2)
    wav = np.ascontiguousarray(wav[:, :n])
    return torch.from_numpy(wav), torch.from_numpy(stft.melspectrogram_np(wav))


def _run(path, head, tmp_path):
    if path == "synthesize":
        pwn = ParallelWavenet(tconfig.load_config(os.path.join(student_dir(), "meta.json")))
        params = weights.load_npz(os.path.join(student_dir(), "params.npz"), device="cpu")
        return parallelgen.synthesize(pwn, params, _inputs()[1], torch.Generator().manual_seed(0))
    model, params, d = _teacher(head)
    fg = Fastgen(model)
    wav, mel = _inputs()
    if path == "feed_forward":
        return model.feed_forward(params, {"wav_scaled": wav, "mel": mel})
    if path == "generate":
        return fg.generate(params, mel, torch.Generator().manual_seed(0), length=8)
    if path == "generate_streaming":
        return fg.generate_streaming(params, mel, torch.Generator().manual_seed(0), length=8, chunk=4)
    if path == "calibrate_act_amax":
        return fg.calibrate_act_amax(params, wav, mel)
    if path == "generate_cuda":
        return fg.generate_cuda(params, mel, seed=0, length=8)
    if path == "generate_wavenet":
        src = tmp_path / "src"
        src.mkdir()
        wav_io.write_wav(str(src / "utt_0.wav"), wav[0].numpy())
        return generate_wavenet(str(src), os.path.join(d, "params.npz"), os.path.join(d, "meta.json"),
                                str(tmp_path / "gen"), device="cpu", sample_length=200, int8=True,
                                int8_static=True)
    raise ValueError(path)


CASES = [(p, "mol") for p in ("generate", "generate_streaming", "calibrate_act_amax", "generate_cuda",
                              "generate_wavenet")]
CASES += [("feed_forward", h) for h in ("mol", "ce", "gauss")] + [("synthesize", "student")]


@pytest.mark.parametrize("path,head", CASES)
def test_f32_paths_run_their_convolutions_without_tf32(recorded, path, head, tmp_path):
    _run(path, head, tmp_path)
    assert recorded, f"{path} ran no convolution"
    assert all(flags == (False, False) for flags in recorded), (path, recorded)
