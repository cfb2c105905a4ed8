"""The port's trainer CLI on its own, from the files of ``test_torch_cli.py``.

* ``--lora-enable`` exports a peft adapter that the JAX package's
  ``load_peft_adapter`` reads (every B moved from zero), and the artifact
  loads through ``load_model(..., model_base=...)`` with each adapted weight
  merged: W + (alpha/r) (A B)^T.
* A run stopped after step 1 resumes from its checkpoint and takes the same
  step 2 as a run that never stopped (equal losses).
* Flags of the JAX CLI that the port cannot honour yet exit with the ROADMAP
  item that brings them; ``--bits`` without ``--lora-enable`` exits as the
  JAX CLI's does.
"""

import os

import jax
import pytest
import torch

from test_torch_cli import _losses, _port, port_stage2, setup  # noqa: F401  (module fixtures)


def test_lora_export_reads_in_jax_and_loads(setup, port_stage2):  # noqa: F811
    import hicom_tpu_torch
    from hicom_tpu.train.lora import load_peft_adapter
    from hicom_tpu_torch.train.lora import lora_from_jax
    from hicom_tpu_torch.weights import convert_projector_state, load_torch_bin

    out = _port(setup, "lora", "port_lora")
    assert len(_losses(out)) == 2
    lora, alpha, rank = load_peft_adapter(out)
    assert (alpha, rank) == (8.0, 4) and len(lora) == 2 * 7
    assert all(p.startswith("language_model/model/layers_") for p in lora)
    adapters = lora_from_jax(jax.device_get(lora))
    assert all(ab["b"].abs().sum() > 0 for ab in adapters.values())
    merged = hicom_tpu_torch.load_model(out, model_base=setup["llm"], dtype="float32", device="cpu")
    base = hicom_tpu_torch.load_model(port_stage2, model_base=setup["llm"], dtype="float32", device="cpu")
    got, ref = merged.model.state_dict(), base.model.state_dict()
    for name, ab in adapters.items():
        delta = (ab["a"] @ ab["b"]).T * (alpha / rank)
        # fp32: the merge rounds W + delta once
        torch.testing.assert_close(got[f"{name}.weight"] - ref[f"{name}.weight"], delta, rtol=1e-5, atol=1e-6)
    # the projector is frozen under LoRA: it leaves as it came from --pretrain-weights
    start = convert_projector_state(load_torch_bin(setup["bin"]))
    assert all(torch.equal(v, start[k].float()) for k, v in got.items() if "mm_projector" in k)


def test_resume_continues_from_the_last_checkpoint(setup, port_stage2):  # noqa: F811
    out = _port(setup, "stage2", "resume", epochs=1)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["1.pt"]
    _port(setup, "stage2", "resume", epochs=2)  # resumes at step 1, takes step 2
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["1.pt", "2.pt"]
    # step 1's learning rate is the peak whatever the total, so the two runs
    # take the same steps on the same batches
    assert _losses(out) == _losses(port_stage2)


@pytest.mark.parametrize("flag", [["--bits", "4"], ["--fsdp", "2"], ["--dp", "2"], ["--offload-optimizer"]])
def test_unported_flags_exit(flag):
    from hicom_tpu_torch.train.cli import main

    # --bits 4/8 is ported (QLoRA) and exits only without --lora-enable, as the JAX CLI does
    match = "--lora-enable" if flag[0] == "--bits" else "ROADMAP"
    with pytest.raises(SystemExit, match=match):
        main(["--model-path", "x", "--data-path", "y", "--output-dir", "z", "--device", "cpu"] + flag)


def test_scan_layers_is_accepted_and_documented():
    from hicom_tpu_torch.train.cli import SCAN_LAYERS_HELP, build_parser

    args = build_parser().parse_args(["--model-path", "x", "--data-path", "y", "--output-dir", "z",
                                      "--scan-layers"])
    assert args.scan_layers and "ignored" in SCAN_LAYERS_HELP
    assert "ignored" in build_parser().format_help()
