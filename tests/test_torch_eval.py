"""The port's eval CLI end to end on the CPU: wavs -> mel -> deconv ->
generate_cuda (its plain version on CPU tensors) -> gen_*.wav, with the
committed golden tiny_mol weights; and npy_only, which serves the .npy mels
of a directory that holds .wav files as well, through discover_files, the
teacher's generate_wavenet and the student's CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import discover_files, load_mel_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the step loops' small products gain nothing from
    more, and the other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_eval_cli_writes_finite_wavs(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i in (0, 1):
        wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))
        wav_io.write_wav(str(src / f"utt_{i}.wav"), wav[:1000])
    files = discover_files(str(src))
    assert [os.path.basename(f) for f in files] == ["utt_0.wav", "utt_1.wav"]
    assert load_mel_batch(files, sample_length=400).shape == (2, 3, 80)

    out = tmp_path / "gen"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the interpreters' work is tiny; spare the other workers
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "eval_wavenet_torch.py"), "--source_path", str(src),
         "--params", os.path.join(GOLDEN, "tiny_mol", "params.npz"),
         "--config", os.path.join(GOLDEN, "tiny_mol", "meta.json"),
         "--save_path", str(out), "--sample_length", "400", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    written = sorted(os.listdir(out))
    assert written == ["gen_utt_0.wav", "gen_utt_1.wav"]
    for name in written:
        wav, sr = wav_io.read_wav(str(out / name))
        assert sr == 16000 and wav.shape == (600,)  # 3 mel frames x 200
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def _mixed_sources(tmp_path):
    """Two wavs and, under other names, two mel-only .npy sources of 4 and 3
    frames."""
    src = tmp_path / "mixed"
    src.mkdir()
    for i in (0, 1):
        wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))
        wav_io.write_wav(str(src / f"utt_{i}.wav"), wav[:1000])
    mels = load_mel_batch(discover_files(str(src)), sample_length=600)  # [2, 4, 80]
    np.save(src / "mel_a.npy", mels[0])
    np.save(src / "mel_b.npy", mels[1, :3])
    return src


def test_discover_files_npy_only(tmp_path):
    src = _mixed_sources(tmp_path)
    names = lambda fs: [os.path.basename(f) for f in fs]  # noqa: E731
    assert names(discover_files(str(src))) == ["utt_0.wav", "utt_1.wav"]
    assert names(discover_files(str(src), npy_only=True)) == ["mel_a.npy", "mel_b.npy"]
    only_npy = tmp_path / "only_npy"
    only_npy.mkdir()
    np.save(only_npy / "m.npy", np.zeros((2, 80), np.float32))
    assert names(discover_files(str(only_npy))) == ["m.npy"]


def test_generate_wavenet_npy_only_serves_the_mels(tmp_path):
    from nsynth_wavenet_tpu_torch.evaluation import generate_wavenet

    src = _mixed_sources(tmp_path)
    paths = generate_wavenet(str(src), os.path.join(GOLDEN, "tiny_mol", "params.npz"),
                             os.path.join(GOLDEN, "tiny_mol", "meta.json"), str(tmp_path / "gen"),
                             device="cpu", npy_only=True)
    assert [os.path.basename(p) for p in paths] == ["gen_mel_a.wav", "gen_mel_b.wav"]
    for p in paths:
        wav, sr = wav_io.read_wav(p)
        # the batch is zero-padded to its longest mel, 4 frames x 200
        assert sr == 16000 and wav.shape == (800,) and np.isfinite(wav).all()


def test_eval_parallel_cli_npy_only(tmp_path):
    src = _mixed_sources(tmp_path)
    out = tmp_path / "gen"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "eval_parallel_wavenet_torch.py"), "--source_path",
         str(src), "--params", os.path.join(GOLDEN, "tiny_student", "params.npz"),
         "--config", os.path.join(GOLDEN, "tiny_student", "meta.json"),
         "--save_path", str(out), "--npy_only", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(out)) == ["gen_mel_a.wav", "gen_mel_b.wav"]
    for name in sorted(os.listdir(out)):
        wav, sr = wav_io.read_wav(str(out / name))
        assert sr == 16000 and len(wav) > 0 and np.isfinite(wav).all()
