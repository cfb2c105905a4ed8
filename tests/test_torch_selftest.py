"""The port's closed loop (train → export → model_init → Video-MME → score)
against the JAX package's, with the same arguments.

Both loops write the same tiny base LLM and tower (``transformers`` from
``torch.manual_seed(0)``), the same media and the same mini Video-MME. JAX
trains at ``--dp 8`` with batch 1 on the 8 virtual CPU devices of
``tests/conftest.py``; the port at batch 8 on the CPU: one global batch of 8
in the same order. Two things are added to both packages' trainer calls
alike, by wrapping each CLI's ``main``: ``--logging-steps 1`` (the loops log
every 20 steps and run 2 and 12, so ``metrics.jsonl`` would be empty), and a
stage-1 ``--pretrain-weights`` written once by the port (each package draws
a fresh projector from its own generator otherwise, so the losses could not
be compared). The step losses then agree within rtol 1e-4 (fp32 on both
sides, other summation orders through 2 tower and 2 decoder layers, and 14
Adam steps at lr 1e-3 that carry the differences forward: 4.1e-6 was the
largest relative difference measured).
"""

import contextlib
import json
import os

import pytest

pytest.importorskip("transformers")
pytest.importorskip("cv2")
pytest.importorskip("pyarrow")

EPOCHS = 12
LOSS_RTOL = 1e-4


@contextlib.contextmanager
def one_thread():
    """The port's loop on one CPU thread: its tiny matmuls gain nothing from
    more, and the test workers share the machine's cores."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def wrap_cli(mp, module, start_bin):
    """``module.main`` with ``--logging-steps 1``, and the stage-1 projector
    from ``start_bin(argv)``."""
    orig = module.main

    def main(argv):
        argv = list(argv) + ["--logging-steps", "1"]
        if "--is-pretraining" in argv:
            argv += ["--pretrain-weights", start_bin(argv)]
        return orig(argv)

    mp.setattr(module, "main", main)


@pytest.fixture(scope="module")
def start_bin(tmp_path_factory):
    """One stage-1 starting projector, drawn by the port from seed 3 at the
    loop's config (the same for both packages' base files)."""
    path = str(tmp_path_factory.mktemp("start") / "mm_projector.bin")

    def make(argv):
        if not os.path.exists(path):
            from hicom_tpu_torch.train.checkpoints import export_mm_projector_bin
            from hicom_tpu_torch.train.cli import build_config, build_parser, init_model

            args = build_parser().parse_args(argv)
            export_mm_projector_bin(init_model(build_config(args), "cpu", seed=3).state_dict(), path)
        return path

    return make


def _run(root, module, start_bin, run):
    with pytest.MonkeyPatch.context() as mp:
        wrap_cli(mp, module, start_bin)
        return run(str(root))


@pytest.fixture(scope="module")
def port_loop(tmp_path_factory, start_bin):
    from hicom_tpu_torch.selftest import run
    from hicom_tpu_torch.train import cli

    with one_thread():
        return _run(tmp_path_factory.mktemp("port_loop"), cli, start_bin,
                    lambda w: run(w, epochs=EPOCHS, device="cpu"))


@pytest.fixture(scope="module")
def jax_loop(tmp_path_factory, start_bin):
    from hicom_tpu import selftest
    from hicom_tpu.train import cli

    return _run(tmp_path_factory.mktemp("jax_loop"), cli, start_bin, lambda w: selftest.run(w, epochs=EPOCHS))


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_port_loop_beats_chance_as_jax_does(port_loop, jax_loop):
    assert port_loop["n_questions"] >= 4
    assert port_loop["videomme_accuracy"] >= 75.0, port_loop
    assert (port_loop["videomme_accuracy"], port_loop["n_questions"]) == \
        (jax_loop["videomme_accuracy"], jax_loop["n_questions"])
    for key in ("mm_projector_bin", "answer_file"):
        assert os.path.exists(port_loop["artifacts"][key])
    assert os.path.isdir(port_loop["artifacts"]["hf_export"])


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_stage_losses_match_jax(port_loop, jax_loop, stage):
    import numpy as np

    got = [r["loss"] for r in port_loop["metrics"][stage]]
    ref = _losses(os.path.join(os.path.dirname(jax_loop["artifacts"]["mm_projector_bin"]), "..", stage))
    assert len(got) == len(ref) == (2 if stage == "stage1" else EPOCHS)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    if stage == "stage2":
        assert got[-1] < got[0]


def test_answer_files_match_jax(port_loop, jax_loop):
    from hicom_tpu_torch.eval.common import merge_chunked_videomme

    got = merge_chunked_videomme([port_loop["artifacts"]["answer_file"]])
    ref = merge_chunked_videomme([jax_loop["artifacts"]["answer_file"]])
    assert got == ref
