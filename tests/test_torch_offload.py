"""``--offload-optimizer`` in the port, and two repairs of faults both packages share.

* The port's CLI runs stage-3 SFT (``test_torch_cli.py``'s files and flags)
  with ``--offload-optimizer`` and without: equal step losses (``==``) and
  equal ``hf_export`` tensors (``torch.equal``). ``test_torch_cli.py`` holds
  the run without the flag to JAX's CLI (rtol 1e-4). JAX's CLI with the flag
  fails at its first step on the CPU backend (its step moves the state
  between memory spaces that backend cannot place), which this file shows.
* A run stopped after step 1 resumes in the other home of the moments and
  takes the same step 2, to the bit, as a run that never stopped.
* ``GroupAdamW`` on a small module with a chunk far below its size (a tensor
  spans several chunks, a chunk several tensors): with ``every_k = 2`` the
  offloaded masters and moments equal the resident ones bit for bit after 4
  micro-batches; one resident step is ``torch.optim.AdamW``'s single-tensor
  step bit for bit; the update allocates no fp32 tensor larger than a chunk.
* ROADMAP Queue 3 item 1: a short non-square video pads with (h, w, 3) black
  frames in the port, where JAX's ``process_video`` fails to stack them;
  square ones pad as JAX's do. (Item 2, ``--calib-video`` on a guide-mode
  export, is tested beside the runner's other cases in
  ``test_torch_eval_runner.py``.)
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_cli import _flags, _losses, setup  # noqa: F401  (module fixture)


def _cli(p, name, epochs=2, offload=False, jax_cli=False):
    if jax_cli:  # one global batch of 8 over JAX's 8 CPU devices, as test_torch_cli.py runs it
        from hicom_tpu.train.cli import main

        batch = ["--per-device-train-batch-size", "1", "--dp", "8"]
    else:
        from hicom_tpu_torch.train.cli import main

        batch = ["--per-device-train-batch-size", "8", "--device", "cpu"]
    out = str(p["root"] / name)
    main(_flags(p, "sft", out, epochs) + batch + (["--offload-optimizer"] if offload else []))
    return out


def _export(out):
    from hicom_tpu_torch.weights import load_hf_state_dict

    return load_hf_state_dict(os.path.join(out, "hf_export"))


@pytest.fixture(scope="module")
def unbroken(setup):  # noqa: F811
    return {home: _cli(setup, f"sft_{home}", offload=home == "offload") for home in ("resident", "offload")}


def test_cli_offload_equals_resident_and_jax_cannot_offload_here(setup, unbroken):  # noqa: F811
    resident, offload = unbroken["resident"], unbroken["offload"]
    assert len(_losses(offload)) == 2 and _losses(offload) == _losses(resident)
    got, want = _export(offload), _export(resident)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    # JAX's CLI keeps its state on the CPU backend's devices under the flag
    # (create_sharded_state's fallback), but its step still moves the state
    # between memory spaces, which that backend cannot compile
    with pytest.raises(jax.errors.JaxRuntimeError, match="annotate_device_placement"):
        _cli(setup, "sft_jax_offload", offload=True, jax_cli=True)


@pytest.mark.parametrize("first,then", [("offload", "resident"), ("resident", "offload")])
def test_resume_across_homes_takes_the_same_step(setup, unbroken, first, then):  # noqa: F811
    name = f"resume_{first}_{then}"
    out = _cli(setup, name, epochs=1, offload=first == "offload")
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["1.pt"]
    _cli(setup, name, epochs=2, offload=then == "offload")  # resumes at step 1, takes step 2
    # step 1's learning rate is the peak whatever the total (no warmup), so both take the unbroken run's steps
    assert _losses(out) == _losses(unbroken[then])
    got, want = _export(out), _export(unbroken[then])
    assert all(torch.equal(got[k], want[k]) for k in want)


class Small(nn.Module):
    """Names that is_tunable and lr_group read: tensors of three
    learning-rate groups (base, projector, vision), decayed and not, an
    embedding of 800 elements."""

    def __init__(self):
        super().__init__()
        self.embed_tokens = nn.Embedding(50, 16)
        self.mm_projector = nn.Sequential(nn.Linear(8, 16), nn.LayerNorm(16))
        self.vision_tower = nn.Linear(8, 8)
        self.norm = nn.LayerNorm(16)
        self.lm_head = nn.Linear(16, 50, bias=False)


CHUNK = 64  # elements: the module trains 1,880 in 30 chunks


def _small(dtype=torch.float32, every_k=1, max_grad_norm=1.0, kind="cosine"):
    from hicom_tpu_torch.train.optimizer import build_optimizer

    torch.manual_seed(0)
    model = Small().to(dtype)
    opt = build_optimizer(model, learning_rate=1e-3, mm_projector_lr=2e-3, vision_tower_lr=5e-4, weight_decay=0.05,
                          total_steps=4, warmup_ratio=0.0, tunable_parts="mm_projector,language_model,pure_vision_model",
                          gradient_accumulation_steps=every_k, max_grad_norm=max_grad_norm, schedule_kind=kind)
    opt.chunk = CHUNK
    return model, opt


def _set_grads(model, seed):
    """Seeded gradients, large enough for the clip to act; one tensor left
    without a gradient on odd seeds."""
    rng = np.random.default_rng(seed)
    for n, p in model.named_parameters():
        g = rng.standard_normal(p.shape).astype(np.float32) * 0.3
        p.grad = None if (seed % 2 and n == "vision_tower.bias") else torch.from_numpy(g).to(p.dtype)


def test_offloaded_accumulation_equals_resident_bit_for_bit():
    model, opt = _small(every_k=2)
    model_o, opt_o = copy.deepcopy(model), copy.deepcopy(opt)
    opt.init(model)
    opt_o.init(model_o, offload=True)
    before = {n: m.clone() for n, m in opt.masters.items()}
    assert max(s.numel() for s in opt.masters.values()) > 4 * CHUNK and len(opt.bounds) == 30
    assert any(len(segs) > 2 for segs in opt.segments)  # a chunk spanning several tensors
    for seed in range(4):
        for m in (model, model_o):
            _set_grads(m, seed)
        torch.testing.assert_close(opt_o.update(model_o), opt.update(model), rtol=0, atol=0)
    assert opt.count == opt_o.count == 2 and opt.mini_step == opt_o.mini_step == 0
    got, want = opt_o.state_dict(), opt.state_dict()
    for kind in ("masters", "exp_avg", "exp_avg_sq"):
        assert all(torch.equal(got[kind][n], want[kind][n]) for n in want[kind]), kind
    assert all(torch.equal(a, b) for a, b in zip(model_o.parameters(), model.parameters()))
    assert not any(torch.equal(want["masters"][n], before[n]) for n in before)


def test_step_is_torch_single_tensor_adamw():
    # no clip and a constant rate: the reference is torch.optim.AdamW's own step over the same groups
    model, opt = _small(max_grad_norm=None, kind="constant")
    opt.init(model)
    masters = {n: m.clone() for n, m in opt.masters.items()}
    lrs = {"base": 1e-3, "projector": 2e-3, "vision": 5e-4}
    ref = torch.optim.AdamW([dict(params=[masters[n]], lr=lrs[opt.labels[n]],
                                  weight_decay=0.05 if opt.decay[n] else 0.0) for n in masters],
                            betas=(0.9, 0.999), eps=1e-8, foreach=False)
    for seed in range(2):
        _set_grads(model, seed)
        for n, m in masters.items():
            g = model.get_parameter(n).grad
            m.grad = torch.zeros_like(m) if g is None else g.float()
        opt.update(model)
        ref.step()
    state = opt.state_dict()
    for n, m in masters.items():
        assert torch.equal(state["masters"][n], m), n
        assert torch.equal(state["exp_avg"][n], ref.state[m]["exp_avg"]), n
        assert torch.equal(state["exp_avg_sq"][n], ref.state[m]["exp_avg_sq"]), n


class NewFloat32(TorchDispatchMode):
    """The largest fp32 tensor an op allocates (outputs that share no
    storage with an input)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        held = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.untyped_storage().data_ptr() not in held:
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("offload", [False, True])
def test_update_allocates_no_fp32_gradient_set(offload):
    # bf16 parameters, as at full size: a whole-set fp32 cast would allocate each tensor's fp32 copy
    model, opt = _small(dtype=torch.bfloat16, every_k=2)
    opt.init(model, offload=offload)
    watch = NewFloat32()
    for seed in range(2):
        _set_grads(model, seed)
        with watch:
            opt.update(model)
    assert opt.count == 1
    assert sum(m.numel() for m in opt.masters.values()) > 25 * CHUNK
    assert 0 < watch.largest <= CHUNK, watch.largest


def _frames(w, h, n, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for _ in range(n)]


def test_short_video_pads_with_frames_of_its_own_shape():
    from hicom_tpu.data.video import process_video as jax_process_video
    from hicom_tpu_torch.data.video import process_video

    square = _frames(64, 64, 3)
    np.testing.assert_array_equal(process_video(square, None, num_frames=8),
                                  jax_process_video(square, None, num_frames=8))
    clip = _frames(640, 360, 3, seed=1)
    got = process_video(clip, None, num_frames=8)
    assert got.shape == (8, 360, 640, 3)
    np.testing.assert_array_equal(got[:3], np.stack([np.asarray(f) for f in clip]))
    assert not got[3:].any()
    with pytest.raises((ValueError, AssertionError)):  # JAX pads with (w, h, 3) frames, which do not stack
        jax_process_video(clip, None, num_frames=8)
