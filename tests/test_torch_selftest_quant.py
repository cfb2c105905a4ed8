"""The port's closed loop re-scored under the serving quantization modes,
held to the bars of the JAX package's ``tests/test_selftest_loop.py``: every
mode scores the fp accuracy, and its greedy tokens agree with fp's on at
least 97% of positions (99% for ``serving_default``). The outlier export is
in ``tests/test_torch_selftest_outlier.py``.
"""

import pytest

pytest.importorskip("transformers")
pytest.importorskip("cv2")
pytest.importorskip("pyarrow")

from test_torch_selftest import one_thread  # noqa: E402

MODES = ["fp", "int8_weight_only", "nf4", "serving_default"]


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    from hicom_tpu_torch.selftest import run

    with one_thread():
        return run(str(tmp_path_factory.mktemp("quant_loop")), epochs=12, quant_modes=MODES, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_quant_mode_scores_fp_accuracy(loop, mode):
    sweep = loop["quant_sweep"]
    assert list(sweep) == MODES
    assert sweep["fp"]["videomme_accuracy"] >= 75.0, sweep
    assert sweep[mode]["videomme_accuracy"] == sweep["fp"]["videomme_accuracy"], sweep
    assert sweep[mode]["token_agreement"] >= (0.99 if mode == "serving_default" else 0.97), sweep
    # only a static mode calibrates (w8a8s tower of serving_default)
    assert (sweep[mode]["act_smooth_max"] is not None) == (mode == "serving_default"), sweep

