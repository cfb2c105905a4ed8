"""Stage-3 full SFT through the port's CLI under ``torch.distributed.run``:
``--dp 2`` and ``--fsdp 2 --tp 2`` against JAX's ``--dp 8`` and the
one-process port, as ``tests/test_torch_mesh_cli.py`` holds stage 2 (its
docstring gives the tolerances and why; it holds JAX's ``--dp 2 --fsdp 2
--tp 2`` to the same losses as its ``--dp 8``)."""

from test_torch_cli import setup  # noqa: F401  (a fixture)
from test_torch_mesh_cli import check_stage


def test_sft_at_dp2_and_fsdp2_tp2_matches_jax_and_one_process(setup):  # noqa: F811
    check_stage(setup, "sft", [["--dp", "8"]])
