"""Quantized checkpoints loaded by the port and by the JAX package.

One exported checkpoint (``tests/test_torch_api.py``'s), loaded by both
packages with a decoder mode and a ``w8a8s_mlp_qkv`` tower: the first
``generate`` self-calibrates (the tower, then a static decoder) to JAX's
``act_scale`` / ``act_smooth`` and both generate the same greedy ids. Every
tower site and the decoder's first sites agree to rtol 1e-6 (a refitted code
may move by one on at most 0.1% of a weight, as the two forwards'
activations round apart by ulps). Deeper decoder sites agree to 5%: their
inputs pass through int8 activation codes upstream, and where an ulp moves
one code across a rounding boundary the activation moves by a whole
quantization step. ``load_model`` takes one decoder quantization at most.
"""

import jax
import numpy as np
import pytest
import torch

from hicom_tpu_torch.weights import state_dict_from_jax

from test_torch_api import exported  # noqa: F401  (module fixture)
from test_torch_quant import TOWER, VIDEO, _assert_refit_codes


@pytest.mark.parametrize("dec_quant", ["int8", "nf4", "w8a8_mlp", "w8a8s"])
def test_quantized_checkpoint_calibrates_and_generates_like_jax(exported, dec_quant):  # noqa: F811
    """One exported checkpoint, loaded by both packages with ``dec_quant`` and
    a ``w8a8s_mlp_qkv`` tower: the first ``generate`` self-calibrates (the
    tower, then a static decoder) to JAX's scales, and the greedy ids agree."""
    import hicom_tpu_torch
    from hicom_tpu.api import load_model as jax_load_model

    rng = np.random.default_rng(12)
    ids = rng.integers(3, 16, (1, 14))
    ids[0, 3] = VIDEO
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    gids = rng.integers(1, 10, (1, 16))
    kw = dict(dtype="float32", cache_len=256, dec_quant=dec_quant, load_w8a8_tower="w8a8s_mlp_qkv")
    jhc = jax_load_model(exported, **kw)
    want = jhc.generate(ids, frames=frames, guide_ids=gids, max_new_tokens=8)
    thc = hicom_tpu_torch.load_model(exported, device="cpu", **kw)
    assert thc.fp_tower_weights and (thc.fp_decoder_weights is not None) == dec_quant.startswith("w8a8s")
    got = thc.generate(ids, frames=frames, guide_ids=gids, max_new_tokens=8)
    assert thc.tower_calibrated and thc.decoder_calibrated == dec_quant.startswith("w8a8s")
    assert thc.fp_tower_weights is None and thc.fp_decoder_weights is None
    ref = state_dict_from_jax(jax.device_get(jhc.params))
    own = thc.model.state_dict()
    assert set(ref) == set(own)
    first = "model.layers.0.mlp." if dec_quant.endswith("_mlp") else "model.layers.0.self_attn."
    n_exact = 0
    for k, v in ref.items():
        site = k.rsplit(".", 1)[0]
        exact = k.startswith(TOWER) or (site.startswith(first) and site.endswith(("q_proj", "k_proj", "v_proj",
                                                                                  "gate_proj", "up_proj")))
        if k.endswith(("act_scale", "act_smooth")):
            n_exact += exact
            np.testing.assert_allclose(own[k].numpy(), v.float().numpy(), rtol=1e-6 if exact else 0.05, err_msg=k)
        elif exact and k.endswith("weight_scale"):
            np.testing.assert_allclose(own[k].numpy(), v.float().numpy(), rtol=1e-6, err_msg=k)
        elif exact and k.endswith("weight_q"):
            _assert_refit_codes(own[k], v, k)
        elif k.endswith(("weight_q", "weight_nf4")) and not dec_quant.startswith("w8a8s"):
            assert torch.equal(own[k], v), k  # converted at load, never refitted
    assert n_exact >= 2 * 3 * 2  # the tower's qkv_quant, fc1, fc2 sites of 2 layers
    np.testing.assert_array_equal(got, want)


def test_load_model_takes_one_decoder_quantization(exported):  # noqa: F811
    import hicom_tpu_torch

    with pytest.raises(ValueError, match="one decoder quantization"):
        hicom_tpu_torch.load_model(exported, device="cpu", load_8bit=True, dec_quant="w8a8")
    with pytest.raises(ValueError, match="quantization"):
        hicom_tpu_torch.load_model(exported, device="cpu", dec_quant="int4")
