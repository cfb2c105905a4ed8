"""LoRA over a mesh is data parallel: QLoRA (``--bits 8 --lora-enable``) at
``--dp 2`` under ``torch.distributed.run`` (gloo, 2 ranks at per-device
batch 4) takes the one-process run's step losses at batch 8 (rtol 1e-5:
the same adapter draw, the base replicated, the adapters' gradients summed
over the ranks in another order), on ``tests/test_torch_cli.py``'s files.
Above dp, ``--bits 8 --lora-enable --fsdp 2`` exits with the JAX CLI's
message, in both CLIs."""

import os

import numpy as np
import pytest

from test_torch_cli import _flags, _losses, setup  # noqa: F401  (a fixture)
from test_torch_mesh_cli import finish, start


def test_qlora_at_dp2_matches_one_process(setup):  # noqa: F811
    from hicom_tpu_torch.train import cli

    run = start(setup, "lora", "qlora_dp2", 2, ["--dp", "2"], 4, extra=["--bits", "8"])
    try:
        one = str(setup["root"] / "qlora_one")
        cli.main(_flags(setup, "lora", one) + ["--bits", "8", "--per-device-train-batch-size", "8",
                                               "--device", "cpu"])
        got = finish(run)
    finally:
        run[1].stop()
    assert len(_losses(got)) == 2 and _losses(got)[0] != _losses(got)[1]
    np.testing.assert_allclose(_losses(got), _losses(one), rtol=1e-5)
    assert sorted(f for f in os.listdir(got) if "adapter" in f) == sorted(f for f in os.listdir(one) if "adapter" in f)


def test_qlora_above_dp_exits_as_jax_does(setup):  # noqa: F811
    from hicom_tpu.train.cli import main as jax_main
    from hicom_tpu_torch.train.cli import main

    flags = _flags(setup, "lora", str(setup["root"] / "qlora_fsdp")) + ["--bits", "8", "--fsdp", "2",
                                                                        "--per-device-train-batch-size", "1"]
    with pytest.raises(SystemExit) as want:
        jax_main(flags)
    with pytest.raises(SystemExit) as got:
        main(flags + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "dp-only" in str(got.value)
