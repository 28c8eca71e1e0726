"""The port's quality and operations tools, one module per tool of the JAX
package's ``tools/`` under the same name, each run as
``python -m nsynth_wavenet_tpu_torch.tools.<name>`` (on the first CUDA device
unless ``--device cpu``):

  * ``quality_smoke``: train a small teacher (or a teacher and student pair)
    on a synthetic corpus and gate the learned model's quality;
  * ``longform_check``: streamed serving over a long utterance, per-second
    tracking that must not decay;
  * ``make_golden_ckpt`` / ``make_golden_wavs``: golden checkpoints in the
    committed int8 layout, and free runs of the committed goldens;
  * ``make_eval_model``: the EMA export of a run directory;
  * ``downsample``: resample a directory of wavs;
  * ``gather_results``: copy every run's artifacts under a root and
    synthesize test utterances with each.

Every tool writes only under the directories it is given (its defaults lie
under the system's temporary directory).
"""
