"""The SmoothQuant fold end to end on the port's trained closed-loop export,
held to the bars of the JAX package's ``tests/test_selftest_loop.py``: with
compensated outlier channels injected into the export
(``selftest._inject_outlier_export``), the fold engages at calibration
(``act_smooth_max > 1`` at one site at least) and the static serving modes
keep the injected model's own fp accuracy at 99% greedy-token agreement.
"""

import os

import pytest

pytest.importorskip("transformers")
pytest.importorskip("cv2")
pytest.importorskip("pyarrow")

from test_torch_selftest import one_thread  # noqa: E402


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    from hicom_tpu_torch.selftest import run

    with one_thread():
        return run(str(tmp_path_factory.mktemp("outlier_loop")), epochs=12, outlier_sweep=True, device="cpu")


def test_outlier_export_engages_the_fold(loop):
    osweep = loop["outlier_sweep"]
    assert os.path.isdir(os.path.join(os.path.dirname(loop["artifacts"]["hf_export"]), "..", "hf_export_outlier"))
    for mode in ("serving_default", "serving_w8a8s_dec"):
        assert osweep[mode]["act_smooth_max"] > 1.0, osweep
        assert osweep[mode]["videomme_accuracy"] == osweep["fp"]["videomme_accuracy"], osweep
        assert osweep[mode]["token_agreement"] >= 0.99, osweep
