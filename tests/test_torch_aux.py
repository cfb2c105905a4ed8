"""The port's auxiliary modules against the JAX package's: ``profiling``
(``StepTimer`` on the same tick times, ``device_time``'s call counts and
chaining, ``trace`` and ``annotate``) and ``utils`` (the rank helpers with
and without a one-process gloo group, ``rank0_print``, ``build_logger``).
"""

import json
import os
import socket
import time

import pytest
import torch


def test_step_timer_matches_jax(monkeypatch):
    from hicom_tpu.profiling import StepTimer as JaxStepTimer
    from hicom_tpu_torch.profiling import StepTimer

    ticks = [10.0, 10.5, 10.75, 12.0, 12.1, 15.0, 15.2]
    rates = []
    for cls in (JaxStepTimer, StepTimer):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls(window=3)
        rates.append([timer.tick() for _ in ticks] + [timer.rate])
    assert rates[0] == rates[1]
    assert rates[1][0] is None and rates[1][-1] == pytest.approx(3 / (0.1 + 2.9 + 0.2))


@pytest.mark.parametrize("iters,chain", [(1, 1), (3, 1), (2, 4)])
def test_device_time_calls_and_chain_on_the_cpu(iters, chain):
    from hicom_tpu_torch.profiling import device_time

    seen = []

    def fn(x, y, n):
        seen.append((x.clone(), y.clone(), n))
        return x * 2, y

    x, y = torch.ones(3), torch.arange(3)
    t = device_time(fn, x, y, 7, iters=iters, chain=chain)
    assert t > 0
    # one warm-up chain, then ``iters`` chains
    assert len(seen) == chain * (iters + 1)
    # the default dependency: floating inputs get 1e-6 more each call of a chain, the rest stays
    want = [torch.ones(3)]
    for _ in range(chain - 1):
        want.append(want[-1] + torch.tensor(1e-6))
    for i, (xs, ys, n) in enumerate(seen):
        assert torch.equal(xs, want[i % chain]) and torch.equal(ys, y) and n == 7
    assert chain == 1 or not torch.equal(want[1], want[0])


def test_device_time_feedback_routes_outputs():
    from hicom_tpu_torch.profiling import device_time

    seen = []

    def fn(x):
        seen.append(float(x[0]))
        return x * 2

    assert device_time(fn, torch.ones(2), chain=3, feedback=lambda out, a: (out,) + a[1:]) > 0
    assert seen == [1.0, 2.0, 4.0, 1.0, 2.0, 4.0]


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    from hicom_tpu_torch.profiling import annotate, trace

    with trace(str(tmp_path)) as prof:
        with annotate("outer-step"):
            with annotate("inner-matmul"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer-step", "inner-matmul")}
    assert set(spans) == {"outer-step", "inner-matmul"}
    outer, inner = spans["outer-step"], spans["inner-matmul"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any(e.key == "inner-matmul" for e in prof.key_averages())


def test_rank_helpers_without_a_process_group(capsys):
    from hicom_tpu import utils as jax_utils
    from hicom_tpu_torch import utils

    for u in (jax_utils, utils):
        assert (u.get_world_size(), u.get_rank(), u.is_main_process()) == (1, 0, True)
        u.synchronize()
        u.rank0_print("hello", 3)
    assert capsys.readouterr().out == "hello 3\nhello 3\n"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_rank_helpers_inside_a_one_process_gloo_group(capsys):
    import torch.distributed as dist

    from hicom_tpu_torch import utils

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        assert (utils.get_world_size(), utils.get_rank(), utils.is_main_process()) == (1, 0, True)
        utils.synchronize()
        utils.rank0_print("from rank 0")
    finally:
        dist.destroy_process_group()
    assert capsys.readouterr().out == "from rank 0\n"
    assert utils.get_world_size() == 1


TWO_RANKS = """
import sys, torch.distributed as dist
from hicom_tpu_torch import utils
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[2], world_size=2, rank=rank)
utils.synchronize()
utils.rank0_print("main", utils.get_rank(), "of", utils.get_world_size())
print("rank", utils.get_rank(), utils.is_main_process())
dist.destroy_process_group()
"""


def test_synchronize_is_a_barrier_across_two_gloo_processes():
    import subprocess
    import sys

    port = str(_free_port())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANKS, str(r), port], cwd=repo, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env={**os.environ, "PYTHONPATH": repo})
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert outs[0][0] == "main 0 of 2\nrank 0 True\n" and outs[1][0] == "rank 1 False\n"


def test_build_logger_matches_jax(tmp_path):
    from hicom_tpu import utils as jax_utils
    from hicom_tpu_torch import utils

    for u, tag in ((jax_utils, "jax"), (utils, "port")):
        path = tmp_path / tag / "logs" / "run.log"
        logger = u.build_logger(f"aux-test-{tag}", str(path))
        assert u.build_logger(f"aux-test-{tag}") is logger
        logger.info("a message")
        for h in logger.handlers:
            h.flush()
        assert path.read_text().endswith(f"| INFO | aux-test-{tag} | a message\n")
        assert [type(h).__name__ for h in logger.handlers] == ["StreamHandler", "TimedRotatingFileHandler"]
