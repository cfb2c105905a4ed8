"""Hygiene of the port: it imports neither JAX nor the JAX package (nor does
a gloo rank process after a sharded step), its entry points refuse to fall
back to the CPU silently, CPU tensors never count as kernel launches, and a
DTensor never reaches a kernel."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import hicom_tpu_torch
for m in pkgutil.walk_packages(hicom_tpu_torch.__path__, "hicom_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith(("jax.", "jaxlib", "hicom_tpu.")) or n == "hicom_tpu")
print("MODULES", len([n for n in sys.modules if n.startswith("hicom_tpu_torch")]))
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    # a fresh interpreter: this test process has JAX loaded by conftest
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split("MODULES ")[1].split()[0])
    assert n_modules >= 20, out.stdout


TRAIN_MODULES = ("hicom_tpu_torch.parallel.mesh", "hicom_tpu_torch.parallel.sharding",
                 "hicom_tpu_torch.train.optimizer", "hicom_tpu_torch.train.train_step",
                 "hicom_tpu_torch.train.checkpoints", "hicom_tpu_torch.train.lora", "hicom_tpu_torch.train.dataset",
                 "hicom_tpu_torch.train.cli", "hicom_tpu_torch.data.image", "hicom_tpu_torch.data.native",
                 "hicom_tpu_torch.data.native_video", "hicom_tpu_torch.data.processor",
                 "hicom_tpu_torch.data.video", "hicom_tpu_torch.data.prompts", "hicom_tpu_torch.weights",
                 "hicom_tpu_torch.models.quant", "hicom_tpu_torch.ops.preprocess", "hicom_tpu_torch.api",
                 "hicom_tpu_torch.serve")


EVAL_MODULES = ("hicom_tpu_torch.eval", "hicom_tpu_torch.eval.common", "hicom_tpu_torch.eval.benchmarks",
                "hicom_tpu_torch.eval.scorers", "hicom_tpu_torch.eval.score", "hicom_tpu_torch.eval.gpt_judge",
                "hicom_tpu_torch.eval.runner", "hicom_tpu_torch.selftest", "hicom_tpu_torch.utils",
                "hicom_tpu_torch.profiling", "hicom_tpu_torch.conversation", "hicom_tpu_torch.bench")


def _imports_no_jax(modules, path=REPO):
    code = f"import importlib, sys\nfor m in {modules!r}: importlib.import_module(m)\n" + \
        "print('BAD', sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'hicom_tpu')))"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": path})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


SEQ_MODULES = ("hicom_tpu_torch.parallel", "hicom_tpu_torch.parallel.long_video", "hicom_tpu_torch.parallel.ring",
               "hicom_tpu_torch.parallel.pipeline", "hicom_tpu_torch.ops.attention", "hicom_tpu_torch.models.generate")


def test_seq_parallel_modules_import_no_jax():
    """The sequence-parallel modules, and the rank workers of their tests
    (``tests/torch_ranks.py``), import neither JAX nor the JAX package."""
    _imports_no_jax(SEQ_MODULES + ("torch_ranks",), os.pathsep.join([REPO, os.path.join(REPO, "tests")]))


def test_train_modules_import_no_jax():
    _imports_no_jax(TRAIN_MODULES)


def test_eval_and_aux_modules_import_no_jax():
    _imports_no_jax(EVAL_MODULES)


@pytest.mark.parametrize("entry", ["build_model", "load_model", "create_train_state", "train_cli", "model_init",
                                   "device_preprocessor", "serve_engine", "serve_engine_mesh", "eval_runner",
                                   "eval_runner_data_parallel", "selftest"])
def test_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    import hicom_tpu_torch
    from hicom_tpu_torch.models.hicom import HIComModel
    from hicom_tpu_torch.train import cli
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "build_model":
            hicom_tpu_torch.build_model(hicom_tpu_torch.tiny_test_config())
        elif entry == "load_model":
            hicom_tpu_torch.load_model(str(tmp_path))
        elif entry == "model_init":
            from hicom_tpu_torch.api import model_init

            model_init(str(tmp_path), device_preprocess=True)
        elif entry == "device_preprocessor":
            from hicom_tpu_torch.ops.preprocess import DeviceSiglipPreprocessor

            DeviceSiglipPreprocessor()
        elif entry == "serve_engine":
            from hicom_tpu_torch.serve import ServeEngine

            ServeEngine(HIComModel(hicom_tpu_torch.tiny_test_config()))
        elif entry == "serve_engine_mesh":  # the device is resolved before the mesh is read
            from hicom_tpu_torch.serve import ServeEngine

            ServeEngine(HIComModel(hicom_tpu_torch.tiny_test_config()), mesh=object())
        elif entry.startswith("eval_runner"):  # --device defaults to cuda; --data-parallel reaches shard_for_eval
            from hicom_tpu_torch.eval import runner

            runner.main(["--benchmark", "videomme", "--model-path", str(tmp_path), "--question-file", "q.parquet",
                         "--answer-file", str(tmp_path / "a.json")]
                        + (["--data-parallel", "--batch-size", "2"] if entry.endswith("parallel") else []))
        elif entry == "selftest":
            from hicom_tpu_torch.selftest import run

            run(str(tmp_path / "loop"))
        elif entry == "train_cli":  # --device defaults to cuda
            cli.run(cli.build_parser().parse_args(["--model-path", "x", "--data-path", "y", "--output-dir",
                                                   str(tmp_path)]), tokenizer=None)
        else:
            model = HIComModel(hicom_tpu_torch.tiny_test_config())
            create_train_state(model, build_optimizer(model, learning_rate=1e-3, tunable_parts="mm_projector"))


def test_rank_processes_hold_no_jax_and_wrappers_refuse_dtensors(tmp_path):
    """Two gloo rank processes take a sharded step; neither imports JAX or the
    JAX package, and every kernel wrapper raises on a DTensor operand (its
    pointer and shape are the wrapper's, not the local shard's)."""
    import torch_ranks as R

    R.spawn(R.hygiene_worker, 2, str(tmp_path / "out.pt"))
    out = torch.load(tmp_path / "out.pt")
    assert out["bad"] == []
    assert set(out["raised"]) == {"K1", "K2", "K3", "K4", "K5/K6", "merge"}
    for kid, msg in out["raised"].items():
        assert msg and "DTensor" in msg, (kid, msg)


def test_cpu_tensors_take_plain_twins_without_counting():
    from hicom_tpu_torch.ops.flash_attention import (flash_backward, flash_forward, flash_forward_partials,
                                                     fullblock_attention, merge_partials)
    from hicom_tpu_torch.ops.flash_decode import flash_decode
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention

    wrappers = (fullblock_attention, flash_forward, flash_backward, flash_decode, fused_tile_attention, merge_partials)
    before = [f.launches for f in wrappers]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 2, 16, 8)).astype(np.float32))
    fullblock_attention(x[0], x[0], x[0], 0.3)
    out, lse = flash_forward(x, x[:, :1], x[:, :1], torch.tensor([9, 16]), 0.3, 0.0, True)
    flash_backward(x, x[:, :1], x[:, :1], torch.tensor([9, 16]), out, lse, x, 0.3, 0.0, True)
    flash_decode(x[:, :, :1], x, x, torch.ones(2, 16, dtype=torch.bool))
    vol = torch.from_numpy(rng.standard_normal((4, 3, 3, 8)).astype(np.float32))
    fused_tile_attention(vol[:1, :1, :1], vol, vol, (4, 3, 3), 0.3)
    parts = flash_forward_partials(x, x[:, :1], x[:, :1], torch.tensor([9, 16]), 0.3, 0.0, True)
    merge_partials(*(torch.cat([p, p]) for p in parts), torch.float32)
    after = [f.launches for f in wrappers]
    assert after == before
