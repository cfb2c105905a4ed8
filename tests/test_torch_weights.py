"""The port's checkpoint pieces against the libraries and the JAX package.

* The port's own safetensors writer and reader (no ``safetensors`` package on
  the card) against the ``safetensors`` package, both ways: equal names,
  dtypes, shapes and bytes, metadata included.
* ``convert_projector_state``'s prefix rules against the JAX package's, on the
  key layouts a ``mm_projector.bin`` or ``non_lora_trainables.bin`` carries.
* ``load_hf_state_dict`` on a ``pytorch_model.bin`` directory.
"""

import pytest
import torch

safetensors_torch = pytest.importorskip("safetensors.torch")


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "model.layers.0.self_attn.q_proj.weight": torch.randn(8, 4, generator=g).to(torch.bfloat16),
        "model.norm.weight": torch.randn(4, generator=g).half(),
        "a.f32": torch.randn(2, 3, 5, generator=g),
        "a.f64": torch.randn(3, generator=g, dtype=torch.float64),
        "ids.i64": torch.randint(-9, 9, (6,), generator=g),
        "ids.i32": torch.randint(-9, 9, (2, 2), generator=g, dtype=torch.int32),
        "ids.i8": torch.randint(-9, 9, (5,), generator=g, dtype=torch.int8),
        "ids.u8": torch.randint(0, 255, (7,), generator=g, dtype=torch.uint8),
        "mask": torch.rand(3, generator=g) > 0.5,
        "logit_scale": torch.tensor(2.5),  # a scalar, shape ()
        "empty": torch.zeros(0, 4),
    }


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("writer", ["port", "package"])
def test_safetensors_round_trip_against_the_package(tmp_path, writer):
    from hicom_tpu_torch.weights import load_safetensors, save_safetensors

    want, meta = _tensors(), {"format": "pt"}
    path = str(tmp_path / "model.safetensors")
    if writer == "port":
        save_safetensors(want, path, metadata=meta)
        _same(safetensors_torch.load_file(path), want)
        from safetensors import safe_open

        with safe_open(path, "pt") as f:
            assert f.metadata() == meta
    else:
        safetensors_torch.save_file(want, path, metadata=meta)
    _same(load_safetensors(path), want)


def _projector_sd():
    from hicom_tpu_torch import config as tcfg
    from hicom_tpu_torch.models.hicom import HIComModel

    torch.manual_seed(0)
    model = HIComModel(tcfg.tiny_test_config(use_guide="direct"))
    return {k: v for k, v in model.state_dict().items() if k.startswith("model.mm_projector.")}


@pytest.mark.parametrize("layout", ["model.mm_projector.", "mm_projector.", "base_model.model.model.mm_projector.",
                                    "stripped"])
def test_convert_projector_state_matches_jax(layout):
    from hicom_tpu.weights import convert_projector_state as jax_convert
    from hicom_tpu_torch.weights import convert_projector_state, state_dict_from_jax

    want = _projector_sd()
    short = {k[len("model.mm_projector."):]: v for k, v in want.items()}
    sd = short if layout == "stripped" else {layout + k: v for k, v in short.items()}
    if layout == "base_model.model.model.mm_projector.":
        sd["base_model.model.model.embed_tokens.weight"] = torch.zeros(3)  # not the projector's: dropped
    _same(convert_projector_state(sd), want)
    ref = state_dict_from_jax({"mm_projector": jax_convert({k: v.numpy() for k, v in sd.items()}, "hicom")})
    _same(ref, want)


def test_load_hf_state_dict_reads_pytorch_bin(tmp_path):
    from hicom_tpu_torch.weights import load_hf_state_dict

    want = {k: v for k, v in _tensors().items() if v.is_floating_point()}
    torch.save(want, tmp_path / "pytorch_model.bin")
    _same(load_hf_state_dict(str(tmp_path)), want)
    with pytest.raises(FileNotFoundError):
        load_hf_state_dict(str(tmp_path / "nothing"))
