"""The port's eval CLI end to end on the CPU: wavs -> mel -> deconv ->
generate_cuda (its plain version on CPU tensors) -> gen_*.wav, with the
committed golden tiny_mol weights."""

import os
import subprocess
import sys

import numpy as np

from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import discover_files, load_mel_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


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
