"""Every mode of the port's bench (``hicom_tpu_torch/bench.py``) run on the
CPU: ``main([..., "--small", "--device", "cpu"])`` prints a last line that
parses as JSON, with the JAX bench's metric name and every time-derived
field null; the module entry point runs in a subprocess; the refusals exit 2
before any work; the source holds no TPU constant, relay or cache path.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hicom_tpu_torch import bench as tb
from test_torch_bench import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = {
    "default": ([], "video_frames_per_sec_per_chip_e2e_prefill"),
    "image": (["--modal", "image"], "image_samples_per_sec_per_chip_e2e_prefill"),
    "decode": (["--decode"], "decode_tok_per_s"),
    "decode_kv_int8": (["--decode", "--kv-int8"], "decode_tok_per_s"),
    "train": (["--train"], "train_step_target_tokens_per_sec_per_chip"),
    "train_bits4": (["--train", "--bits", "4"], "train_step_target_tokens_per_sec_per_chip"),
    "from_disk": (["--from-disk"], "video_frames_per_sec_per_chip_from_disk"),
    "from_disk_host": (["--from-disk", "--host-preprocess"], "video_frames_per_sec_per_chip_from_disk"),
}
TIME_FIELDS = {"ttft_ms_per_video", "achieved_tflops", "mfu_pct", "group_ms", "step_ms", "ingest_only_fps",
               "chip_only_fps", "pipelined_from_disk_fps", "upload_plus_one_ingest_ms", "peak_gb"}


@pytest.mark.parametrize("mode", list(MODES))
def test_small_cpu_run_prints_a_json_line_without_times(mode, capsys):
    flags, metric = MODES[mode]
    with one_thread():
        assert tb.main(["--small", "--device", "cpu", "--iters", "4", "--sync-every", "2"] + flags) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(last)
    assert res["metric"] == metric
    assert res["value"] is None and res["vs_baseline"] is None
    detail = res["detail"]
    for key in TIME_FIELDS & set(detail):
        assert detail[key] is None, key
    for row in detail.get("table", ()):
        assert row["ms_per_step"] is None and row["tok_per_s"] is None
    assert detail["device"]["platform"] == "cpu" and detail["card_stamp"] is None
    assert set(detail["kernel_launches"]) == {"fullblock_attention", "flash_forward", "flash_decode",
                                              "fused_tile_attention", "flash_backward"}
    assert not any(detail["kernel_launches"].values())  # CPU tensors take the plain twins
    if mode == "train_bits4":
        assert detail["tunable_parts"] == "qlora_nf4_r64" and np.isfinite(detail["loss"])
    if mode.startswith("decode"):
        assert detail["kv_int8"] == mode.endswith("int8") and [r["batch"] for r in detail["table"]] == [1, 4, 8]


def test_module_entry_point_runs_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "hicom_tpu_torch.bench", "--small", "--device", "cpu", "--iters",
                          "2", "--sync-every", "2"], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metric"] == "video_frames_per_sec_per_chip_e2e_prefill" and res["value"] is None


@pytest.mark.parametrize("argv", [[], ["--decode"], ["--small"], ["--device", "cpu"], ["--device", "cpu", "--train"],
                                  ["--train", "--model", "7b", "--small", "--device", "cpu"],
                                  ["--bits", "4", "--small", "--device", "cpu"]])
def test_refusals_exit_nonzero(argv, monkeypatch, capsys):
    """No card and no ``--device cpu``, ``--device cpu`` without ``--small``,
    a 16-bit 7B train step and ``--bits`` without ``--train`` all exit 2
    before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tb.main(argv)
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_no_tpu_constants_relay_or_cache_in_the_port():
    with open(os.path.join(REPO, "hicom_tpu_torch", "bench.py")) as f:
        src = f.read()
    for word in ("131.0", "199.5", "56.0", "159e9", "tpu_alive", "relay", "_cached_fallback", "bench_cache",
                 "HICOM_FLASH", "jax", "hicom_tpu.", "import bench", "scripts"):
        assert word not in src, word
