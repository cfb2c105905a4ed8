"""Benchmark eval harness of the port (a copy of ``hicom_tpu/eval``).

Single-command per benchmark (replaces the reference's per-GPU bash fan-out,
``scripts/eval/video/*.sh``):

    python -m hicom_tpu_torch.eval.runner --benchmark videomme \
        --model-path CKPT --video-folder ... --question-file ... --answer-file out.json
    python -m hicom_tpu_torch.eval.score --benchmark videomme --results out.json

The runner takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
paths). Inference prompts, answer extraction and scoring reproduce the
reference (its ``hicom/eval/``) so accuracies are comparable; every module
but ``runner.py`` is the JAX package's text.
"""
