"""The port's sharded train step against its unsharded step, in gloo groups.

``tests/torch_ranks.py`` builds the tiny guide-mode model (fp32, decoder and
projector trained, tower and guide encoder frozen) from one seed, and takes
two steps over two global batches of 4 rows whose halves hold very
different numbers of target tokens. Two rank processes run the meshes (2, 1,
1), (1, 2, 1), (1, 1, 2) and (1, 2, 1) with remat; four run (1, 2, 2). Each
must equal the unsharded step on the whole batch, in this process:

* the loss and target tokens (rtol 1e-5): the global batch's token mean,
  which an average of the ranks' own means misses by far on these batches;
* the grad norm (rtol 1e-5), past ``max_grad_norm`` at every step, so the
  clip is active and a tp-replicated tensor counted twice would show;
* every fp32 master after two steps: rtol 1e-5 and atol 0.1 x lr, since
  AdamW's first steps move an element by about lr x g / (|g| + eps) and a
  gradient near eps flips with the last bits of another summation order.

q_proj's parameter and master are smaller than the whole tensor at fsdp 2
and tp 2; the frozen tensors are bit-identical after the steps; a checkpoint
saved at fsdp 2 after the first step resumes in one process to the second
step's loss of the unbroken run.

At (1, 2, 1) and (1, 2, 2) the state is saved, its parameters gathered for an
export and the checkpoint restored into a fresh sharded state, each under a
``TorchDispatchMode`` watch (``torch_ranks.DeviceWholes``): no rank ever holds
two whole tensors made on its device at once (a gathered tensor goes to the
host before the next is gathered), the file is mapped, not read whole, rank 0
alone holds the gathered maps, and the restored local parts equal the saved
ones bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import torch_ranks as R
from hicom_tpu_torch.train.train_step import create_train_state

TWO = {"dp": (2, 1, 1), "fsdp": (1, 2, 1), "tp": (1, 1, 2), "fsdp_remat": (1, 2, 1)}
FOUR = {"fsdp_tp": (1, 2, 2)}
LR = 1e-3


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train")
    cases = [dict(name=n, shape=s, remat=n.endswith("remat"), save_to=str(root / "ckpt") if n == "fsdp" else None,
                  roundtrip=str(root / "rt_fsdp") if n == "fsdp" else None) for n, s in TWO.items()]
    R.spawn(R.train_worker, 2, cases, str(root / "two.pt"))
    R.spawn(R.train_worker, 4, [dict(name=n, shape=s, roundtrip=str(root / f"rt_{n}")) for n, s in FOUR.items()],
            str(root / "four.pt"))
    out = {**torch.load(root / "two.pt"), **torch.load(root / "four.pt")}
    out["ckpt"] = str(root / "ckpt")
    return out


@pytest.fixture(scope="module")
def unsharded():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, opt, batches = R.build()
        metrics = R.run_steps(create_train_state(model, opt, "cpu"), batches)
        return metrics, opt.state_dict()["masters"], batches
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("case", [*TWO, *FOUR])
def test_sharded_step_equals_unsharded(sharded, unsharded, case):
    got, (ref, masters, _) = sharded[case], unsharded
    for key in ("loss", "target_tokens", "grad_norm"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)
    assert min(ref["grad_norm"]) > 1.0  # the clip (max_grad_norm 1.0) acts at every step
    assert set(got["masters"]) == set(masters)
    for name, m in masters.items():
        np.testing.assert_allclose(got["masters"][name].numpy(), m.numpy(), rtol=1e-5, atol=0.1 * LR, err_msg=name)


def test_loss_is_the_global_token_mean(sharded, unsharded):
    """The halves of each batch hold very different numbers of targets: the
    mean of the two data ranks' own means is far from the global mean that
    every data-parallel mesh reports."""
    from hicom_tpu_torch.train.train_step import make_loss_fn

    model, _, batches = R.build()
    ref = unsharded[0]
    for i, b in enumerate(batches):
        t = {k: torch.as_tensor(v) for k, v in b.items()}
        with torch.no_grad():
            halves = [make_loss_fn(model)({k: v[sl] for k, v in t.items()})[1]
                      for sl in (slice(0, 2), slice(2, 4))]
        counts = [int(h["target_tokens"]) for h in halves]
        assert counts[0] > 3 * counts[1] > 0, counts
        mean_of_means = (float(halves[0]["loss"]) + float(halves[1]["loss"])) / 2
        assert abs(mean_of_means - ref["loss"][i]) > 1e-3 * abs(ref["loss"][i])
        for case in ("dp", "fsdp", "fsdp_tp"):
            np.testing.assert_allclose(sharded[case]["loss"][i], ref["loss"][i], rtol=1e-5)


@pytest.mark.parametrize("case,parts", [("fsdp", 2), ("tp", 2), ("fsdp_tp", 4), ("dp", 1)])
def test_parameters_and_state_are_sharded(sharded, case, parts):
    local, whole = sharded[case]["q_proj_numel"]
    assert local * parts == whole
    assert sharded[case]["q_proj_master_numel"] == local


@pytest.mark.parametrize("case", [*TWO, *FOUR])
def test_frozen_parts_do_not_move(sharded, case):
    assert sharded[case]["frozen_count"] > 50
    assert sharded[case]["frozen_moved"] == []


def test_remat_under_fsdp_equals_no_remat(sharded):
    got, ref = sharded["fsdp_remat"], sharded["fsdp"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)
    for name, m in ref["masters"].items():
        np.testing.assert_allclose(got["masters"][name].numpy(), m.numpy(), rtol=1e-5, atol=0.1 * LR, err_msg=name)


def test_checkpoint_at_fsdp2_resumes_in_one_process(sharded):
    from hicom_tpu_torch.train.checkpoints import restore_checkpoint

    model, opt, batches = R.build()
    state = create_train_state(model, opt, "cpu")
    assert os.listdir(os.path.join(sharded["ckpt"], "checkpoints")) == ["1.pt"]
    assert restore_checkpoint(sharded["ckpt"], state) is not None and state.step == 1
    got = R.run_steps(state, batches[1:])
    np.testing.assert_allclose(got["loss"], sharded["fsdp"]["loss"][1:], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], sharded["fsdp"]["grad_norm"][1:], rtol=1e-5)
    for name, m in sharded["fsdp"]["masters"].items():
        np.testing.assert_allclose(opt.masters[name].numpy(), m.numpy(), rtol=1e-5, atol=0.1 * LR, err_msg=name)


@pytest.mark.parametrize("case", ["fsdp", "fsdp_tp"])
def test_save_and_restore_hold_one_whole_tensor_on_the_device(sharded, case):
    rt = sharded[case]["roundtrip"]
    assert rt["sharded"] == rt["params"] and rt["watched"] >= 10, rt
    for rank, got in enumerate(rt["ranks"]):
        assert got["save_most"] <= 1 and got["restore_most"] <= 1, (rank, got)
        assert got["mapped"] and got["same"], (rank, got)
        assert got["maps"] == ((rt["params"], rt["trained"], rt["trained"]) if rank == 0 else (0, 0, 0)), (rank, got)
