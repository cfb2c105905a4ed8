"""The port's trainer CLI with ``--bits 4`` / ``--bits 8`` against the JAX CLI's.

On ``tests/test_torch_cli.py``'s locally written checkpoint and data, with
``--lora-enable``: both CLIs start from JAX's adapter draw and take the same
step losses (rtol 1e-4, as ``test_torch_cli.py``), and the export loads onto
the float base; ``--bits`` without ``--lora-enable`` exits.
"""

import jax
import numpy as np
import pytest
import torch

from hicom_tpu.train import lora as jlora
from hicom_tpu_torch.train import lora as tlora

from test_torch_cli import _flags, _losses, setup  # noqa: F401  (module fixture)


def _jax_init_for_port(seed):
    """The port CLI's adapter init replaced by JAX's draw for the same targets
    (JAX's PRNG cannot be replayed in PyTorch): the float tree JAX's
    ``init_lora_params`` sees has only the targets' paths and shapes."""

    def init(model, rank=8, generator=None, **kw):
        tree = {}
        for name, (din, dout) in tlora.target_kernels(model).items():
            node = tree.setdefault("language_model", {})
            for part in name.replace("layers.", "layers_").split("."):
                node = node.setdefault(part, {})
            node["kernel"] = np.zeros((din, dout), np.float32)
        lora = jlora.init_lora_params(tree, rank=rank, rng=jax.random.PRNGKey(seed))
        return tlora.lora_from_jax(jax.device_get(lora))

    return init


@pytest.mark.parametrize("bits", [4, 8])
def test_cli_bits_step_losses_match_jax(setup, bits, monkeypatch):  # noqa: F811
    import hicom_tpu_torch
    from hicom_tpu.train.cli import main as jax_main
    from hicom_tpu_torch.train import cli, lora

    flags = ["--bits", str(bits)]
    jout = str(setup["root"] / f"jax_bits{bits}")
    jax_main(_flags(setup, "lora", jout) + flags + ["--per-device-train-batch-size", "1", "--dp", "8"])
    monkeypatch.setattr(lora, "init_lora_params", _jax_init_for_port(42))
    tout = str(setup["root"] / f"port_bits{bits}")
    cli.main(_flags(setup, "lora", tout) + flags + ["--per-device-train-batch-size", "8", "--device", "cpu"])
    got, want = _losses(tout), _losses(jout)
    assert len(got) == len(want) == 2 and got[0] != got[1]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the adapter trained over the quantized base loads onto the float base
    hc = hicom_tpu_torch.load_model(tout, model_base=setup["llm"], dtype="float32", device="cpu")
    assert all(isinstance(m, torch.nn.Linear) for n, m in hc.model.named_modules() if n.endswith("q_proj"))


def test_bits_needs_lora_enable():
    from hicom_tpu_torch.train.cli import main

    with pytest.raises(SystemExit, match="--lora-enable"):
        main(["--model-path", "x", "--data-path", "y", "--output-dir", "z", "--device", "cpu", "--bits", "8"])
