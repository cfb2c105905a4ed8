"""The port's CLI under ``torch.distributed.run`` (gloo, ``--device cpu``) against
the JAX CLI and the one-process port, stage 2, on ``tests/test_torch_cli.py``'s
files (``tests/test_torch_mesh_cli_sft.py`` runs stage-3 full SFT).

``--dp 2`` runs 2 ranks at per-device batch 4 and ``--fsdp 2 --tp 2`` 4
ranks at batch 2; JAX runs ``--dp 8`` and ``--dp 2 --fsdp 2 --tp 2`` on its
8 virtual devices at batch 1. Every run takes one global batch of 8 in the
same order, so the step losses in ``metrics.jsonl`` agree (fp32,
``--logging-steps 1``, rtol 1e-4, as ``tests/test_torch_cli.py`` holds the
one-process port to JAX). Rank 0 alone writes the metrics and the export;
the export matches the one-process port's: the same tensors, equal within
rtol 1e-5 and 1e-4 absolute (a tenth of the largest learning rate: the
ranks sum the gradients in another order, and AdamW's first steps move an
element by about lr x g / (|g| + eps), which flips for a gradient near eps),
and it loads through ``load_model``.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_ranks as R
from test_torch_cli import _flags, _losses, _port, setup  # noqa: F401  (setup is a fixture)

MESHES = {"dp2": (2, ["--dp", "2"], 4), "fsdp2_tp2": (4, ["--fsdp", "2", "--tp", "2"], 2)}


def start(p, stage, name, nproc, mesh_flags, batch, extra=()):
    out = str(p["root"] / name)
    flags = _flags(p, stage, out) + list(mesh_flags) + list(extra) + [
        "--per-device-train-batch-size", str(batch), "--device", "cpu"]
    return out, R.Torchrun(nproc, flags, out + ".log")


def finish(run) -> str:
    out, proc = run
    rc, log = proc.wait()
    assert rc == 0, log[-4000:]
    return out


def jax_cli(p, stage, name, mesh_flags):
    from hicom_tpu.train.cli import main

    out = str(p["root"] / name)
    main(_flags(p, stage, out) + ["--per-device-train-batch-size", "1"] + mesh_flags)
    return out


def export_tensors(out, stage):
    if stage == "stage2":
        return torch.load(os.path.join(out, "mm_projector.bin"), weights_only=True)
    from hicom_tpu_torch.weights import load_hf_state_dict

    return load_hf_state_dict(os.path.join(out, "hf_export"))


def same_export(got, want, stage):
    a, b = export_tensors(got, stage), export_tensors(want, stage)
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k].float().numpy(), b[k].float().numpy(), rtol=1e-5, atol=1e-4, err_msg=k)


def check_stage(p, stage, jax_meshes):
    """Start both meshes, compute the references meanwhile (the JAX CLI on
    each of ``jax_meshes``, the one-process port), hold every run to them."""
    import hicom_tpu_torch

    runs = {m: start(p, stage, f"{m}_{stage}", *spec) for m, spec in MESHES.items()}
    try:
        refs = [jax_cli(p, stage, f"jax_{'_'.join(m)}_{stage}", m) for m in jax_meshes]
        one = _port(p, stage, f"one_{stage}")
        outs = {m: finish(run) for m, run in runs.items()}
    finally:
        for _, proc in runs.values():
            proc.stop()
    for mesh, got in outs.items():
        assert len(_losses(got)) == 2, mesh
        for ref in refs:
            np.testing.assert_allclose(_losses(got), _losses(ref), rtol=1e-4, err_msg=f"{mesh} vs {ref}")
        np.testing.assert_allclose(_losses(got), _losses(one), rtol=1e-5, err_msg=mesh)
        with open(os.path.join(got, "metrics.jsonl")) as f:
            assert [json.loads(line)["step"] for line in f] == [1, 2], mesh  # rank 0 alone writes
        same_export(got, one, stage)
        art, kw = (got, dict(model_base=p["llm"])) if stage == "stage2" else (os.path.join(got, "hf_export"), {})
        hc = hicom_tpu_torch.load_model(art, dtype="float32", device="cpu", **kw)
        assert sum(t.numel() for t in hc.model.parameters()) > 0


def test_stage2_at_dp2_and_fsdp2_tp2_matches_jax_and_one_process(setup):  # noqa: F811
    check_stage(setup, "stage2", [["--dp", "8"], ["--dp", "2", "--fsdp", "2", "--tp", "2"]])
