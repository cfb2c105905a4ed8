"""The port's quantized linears, converters and calibration against the JAX package.

On the CPU, in fp32:

* the activation quantizers' codes and scales, every converter's codes and
  scales (tower modes, decoder ``int8`` / ``nf4`` / ``w8a8s`` / ``w8a8_mlp``,
  ``prune_fp_kernels``) are bit-equal to JAX's;
* each quantized linear gives JAX's module output (rtol 1e-5, atol 1e-6:
  the int32 sums are exact on both sides, the float epilogues round alike);
* ``fill_act_scales`` on the constructions of ``tests/test_quant_outliers.py``
  and on a profile whose two middle channels straddle the outlier threshold
  gives JAX's codes (equal) and scales and factors (rtol 1e-6: the
  SmoothQuant factors' powers round an ulp apart in XLA and PyTorch);
* the repairs: a quantized config is built quantized, and a mode the port
  does not run raises.

A whole checkpoint under each mode: ``tests/test_torch_quant_load.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models import qwen2 as jq2
from hicom_tpu.models import quant as jq
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.models.siglip import SiglipVisionTower as JTower
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import quant as tq
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.models.siglip import SiglipVisionTower as TTower
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO = -201
TOWER = "model.vision_tower.vision_tower."


def _params(seed=0):
    cfg = jcfg.tiny_test_config(use_guide="direct")
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (1, 12))
    ids[0, 2] = VIDEO
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    params = JModel(config=cfg).init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(frames),
                                     guide_ids=jnp.asarray(rng.integers(1, 250, (1, 16))))["params"]
    return dict(jax.device_get(params))


def _assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 96), (1, 1, 128)])
def test_activation_quantizers_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[-1])).astype(np.float32)
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq_, js = jq.quantize_rows(jnp.asarray(x))
    assert torch.equal(q, torch.from_numpy(np.asarray(jq_))) and torch.equal(s, torch.from_numpy(np.asarray(js)))
    for scale in (np.float32(0.037), (rng.uniform(0.5, 2, shape[-1]) * 0.05).astype(np.float32)):
        got = tq.quantize_static(torch.from_numpy(x), torch.as_tensor(scale))
        want = np.asarray(jq.quantize_static(jnp.asarray(x), jnp.asarray(scale)))
        assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("mode", tq.TOWER_MODES)
def test_quantize_tower_params_bit_equal(mode):
    params = _params()
    sd = state_dict_from_jax({"vision_tower": params["vision_tower"]})
    want = state_dict_from_jax({"vision_tower": jq.quantize_tower_params(params["vision_tower"], mode)})
    _assert_same(tq.quantize_tower_params(sd, mode), want)
    fp = tq.prune_fp_kernels(sd, mode)
    jfp = jq.prune_fp_kernels(params["vision_tower"], mode)
    want_fp = {k[: -len(".weight")]: v for k, v in state_dict_from_jax({"vision_tower": jfp}).items()} if jfp else {}
    _assert_same(fp, want_fp)


@pytest.mark.parametrize("mode", ["int8", "nf4", "w8a8s", "w8a8_mlp", "w8a8s_mlp"])
def test_quantize_decoder_params_bit_equal(mode):
    params = _params(1)
    sd = state_dict_from_jax({"language_model": params["language_model"]})
    want = state_dict_from_jax({"language_model": jq2.quantize_decoder_params(params["language_model"], mode)})
    _assert_same(tq.quantize_decoder_params(sd, mode), want)
    targets = jq.decoder_quant_targets(mode)
    jfp = jq.prune_fp_kernels(params["language_model"], mode, targets=targets)
    want_fp = {k[: -len(".weight")]: v for k, v in state_dict_from_jax({"language_model": jfp}).items()} if jfp else {}
    _assert_same(tq.prune_fp_kernels(sd, mode, targets=tq.decoder_quant_targets(mode)), want_fp)


def _jax_dense(cls, params, *args, **kw):
    return np.asarray(cls(**kw).apply({"params": params}, *args))


@pytest.mark.parametrize("kind", ["int8", "nf4", "w8a8", "w8a8_q", "w8a8s", "w8a8s_calib", "act_quant"])
def test_quantized_linear_matches_jax(kind):
    rng = np.random.default_rng(3)
    din, dout = 128, 48
    w = (rng.standard_normal((din, dout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(dout) * 0.01).astype(np.float32)
    x = rng.standard_normal((3, 5, din)).astype(np.float32)
    x[..., 7] *= 20.0
    tw = torch.from_numpy(w.T.copy())
    if kind in ("int8", "nf4"):
        jp = jq2.quantize_decoder_params({"mlp": {"up_proj": {"kernel": w, "bias": b}}}, kind)["mlp"]["up_proj"]
        jcls = jq2.QuantDense if kind == "int8" else jq2.QuantDense4
        want = _jax_dense(jcls, jp, jnp.asarray(x), features=dout, use_bias=True, dtype=jnp.float32)
        mod = (tq.QuantLinear if kind == "int8" else tq.QuantLinear4)(din, dout, True, torch.float32)
        mod.set_weight(tw)
        mod.bias.data.copy_(torch.from_numpy(b))
        got = mod(torch.from_numpy(x))
    elif kind == "act_quant":
        scale, smooth = np.float32(0.05), rng.uniform(0.5, 2.0, din).astype(np.float32)
        jp = {"act_scale": scale, "act_smooth": smooth}
        wq, ws = jq.ActQuant().apply({"params": jp}, jnp.asarray(x))
        mod = tq.ActQuant(din)
        mod.act_scale.fill_(float(scale))
        mod.act_smooth.copy_(torch.from_numpy(smooth))
        got_q, got_s = mod(torch.from_numpy(x))
        assert torch.equal(got_q, torch.from_numpy(np.asarray(wq))) and float(got_s) == float(ws)
        return
    else:
        static = kind.startswith("w8a8s")
        jp = jq.quantize_tower_params({"fc1": {"kernel": w, "bias": b}}, "w8a8s" if static else "w8a8")["fc1"]
        if static:
            jp = {**jp, "act_scale": np.float32(0.07), "act_smooth": rng.uniform(0.5, 2, din).astype(np.float32)}
        mod = (tq.W8A8LinearS if static else tq.W8A8Linear)(din, dout, True, torch.float32)
        mod.set_weight(tw)
        mod.bias.data.copy_(torch.from_numpy(b))
        if static:
            mod.act_scale.fill_(float(jp["act_scale"]))
            mod.act_smooth.copy_(torch.from_numpy(jp["act_smooth"]))
        if kind == "w8a8_q":
            xq, sx = jq.quantize_rows(jnp.asarray(x))
            want = _jax_dense(jq.W8A8DenseQ, jp, xq, sx, features=dout, dtype=jnp.float32)
            got = mod.forward_q(*tq.quantize_rows(torch.from_numpy(x)))
        elif kind == "w8a8s_calib":
            model = jq.W8A8DenseS(dout, dtype=jnp.float32, calibrate=True)
            y, mut = model.apply({"params": jp}, jnp.asarray(x), mutable=["calib"])
            want = np.asarray(y)
            mod.calibrate = True
            got = mod(torch.from_numpy(x))
            assert float(mod.act_amax) == float(mut["calib"]["act_amax"])
            assert torch.equal(mod.act_amax_ch, torch.from_numpy(np.asarray(mut["calib"]["act_amax_ch"])))
        else:
            jcls = jq.W8A8DenseS if static else jq.W8A8Dense
            want = _jax_dense(jcls, jp, jnp.asarray(x), features=dout, dtype=jnp.float32)
            got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


OUT_CH = [3, 17, 40]


def _dense_case(outliers: bool, even_median: bool = False):
    """tests/test_quant_outliers.py's dense site (64 -> 48, 256 rows), with or
    without 80x hot channels; ``even_median`` gives 4 channels whose two
    middle absmax values straddle the threshold: max/lower > 8 > max/mean."""
    rng = np.random.default_rng(0)
    in_dim, out_dim, n = (4, 8, 16) if even_median else (64, 48, 256)
    x = rng.standard_normal((n, in_dim)).astype(np.float32)
    w = (rng.standard_normal((in_dim, out_dim)) * 0.05).astype(np.float32)
    if outliers:
        x[:, OUT_CH] *= 80.0
        w[OUT_CH, :] /= 80.0
    if even_median:  # channel absmax 1, 1, 2, 10: median 1.5 (jnp) vs 1 (torch.median)
        x = x / np.abs(x).max(axis=0) * np.array([1.0, 1.0, 2.0, 10.0], np.float32)
    b = np.zeros(out_dim, np.float32)
    qp = jq.quantize_tower_params({"fc1": {"kernel": w, "bias": b}}, "w8a8s")["fc1"]
    return qp, x, {"kernel": w}


def _port_site(qp):
    sd = state_dict_from_jax({"mm_projector": {"fc1": qp}})
    return {k.replace("model.mm_projector.fc1.", ""): v for k, v in sd.items()}


@pytest.mark.parametrize("case", ["outliers_fp", "outliers_int8", "outliers_off", "no_outliers", "even_median"])
def test_fill_act_scales_matches_jax(case):
    qp, x, fp = _dense_case(outliers=case.startswith("outliers"), even_median=case == "even_median")
    _, mut = jq.W8A8DenseS(int(qp["kernel_scale"].shape[0]), dtype=jnp.float32, calibrate=True).apply(
        {"params": jax.tree.map(jnp.asarray, qp)}, jnp.asarray(x), mutable=["calib"])
    jcalib = jax.device_get(mut["calib"])
    kw = dict(outlier_ratio=float("inf")) if case == "outliers_off" else {}
    use_fp = case in ("outliers_fp", "no_outliers", "even_median")
    want = jq.fill_act_scales(qp, jcalib, fp_params=fp if use_fp else None, **kw)

    mod = tq.W8A8LinearS(x.shape[1], qp["kernel_scale"].shape[0], True, torch.float32)
    mod.load_state_dict(_port_site(qp))
    mod.calibrate = True
    mod(torch.from_numpy(x))
    calib = {"fc1.act_amax": mod.act_amax, "fc1.act_amax_ch": mod.act_amax_ch}
    params = {f"fc1.{k}": v for k, v in mod.state_dict().items()}
    tfp = {"fc1": torch.from_numpy(fp["kernel"].T.copy())} if use_fp else None
    got = tq.fill_act_scales(params, calib, fp_params=tfp, **kw)
    ref = _port_site(jax.device_get(want))
    assert torch.equal(got["fc1.weight_q"], ref["weight_q"])
    for k in ("weight_scale", "act_scale", "act_smooth"):
        np.testing.assert_allclose(got[f"fc1.{k}"].numpy(), ref[k].numpy(), rtol=1e-6)
    if case == "even_median":  # jnp.median's mean of the middle pair: no fold here
        assert torch.equal(got["fc1.act_smooth"], torch.ones(4))
    elif case.startswith("outliers") and case != "outliers_off":
        assert float(got["fc1.act_smooth"].max()) > 1.0


def test_tower_outliers_through_shared_qkv_site_match_jax():
    """test_quant_outliers.py's tower with hot layer-norm gains: the port's
    calibration mode records JAX's amax and its fill folds the shared q/k/v
    site and the MLP sites as JAX's does, from the fp16 weight copies."""
    cfg = jcfg.SiglipVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                  num_attention_heads=4, image_size=56, patch_size=14)
    mode = "w8a8s_mlp_qkv"
    rng = np.random.default_rng(5)
    px = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    params = jax.device_get(JTower(config=cfg, dtype=jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(px))["params"])
    for layer in params["encoder"].values():
        for ln in ("layer_norm1", "layer_norm2"):
            s = np.array(layer[ln]["scale"])
            s[OUT_CH] *= 60.0
            layer[ln]["scale"] = s
        for proj in ("q_proj", "k_proj", "v_proj"):
            k = np.array(layer["self_attn"][proj]["kernel"])
            k[OUT_CH, :] /= 60.0
            layer["self_attn"][proj]["kernel"] = k
        k = np.array(layer["mlp"]["fc1"]["kernel"])
        k[OUT_CH, :] /= 60.0
        layer["mlp"]["fc1"]["kernel"] = k
    qparams = jq.quantize_tower_params(params, mode)
    _, mut = JTower(config=dataclasses.replace(cfg, quantization=mode + "+calib"), dtype=jnp.float32).apply(
        {"params": jax.tree.map(jnp.asarray, qparams)}, jnp.asarray(px), mutable=["calib"])
    want = jq.fill_act_scales(qparams, jax.device_get(mut["calib"]), fp_params=jq.prune_fp_kernels(params, mode))

    def port(tree):
        sd = state_dict_from_jax({"vision_tower": tree})
        return {k[len(TOWER):]: v for k, v in sd.items()}

    tcfg_ = tcfg.SiglipVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                    num_attention_heads=4, image_size=56, patch_size=14, quantization=mode)
    tower = TTower(tcfg_, with_head=True, dtype=torch.float32)
    tower.load_state_dict(port(qparams))
    sites = tq.calibration_sites(tower)
    for m in sites.values():
        m.calibrate = True
    with torch.no_grad():
        tower(torch.from_numpy(px))
    calib = {}
    for n, m in sites.items():
        calib[f"{n}.act_amax"], calib[f"{n}.act_amax_ch"] = m.act_amax, m.act_amax_ch
    fp = {k[: -len(".weight")]: v for k, v in port(jq.prune_fp_kernels(params, mode)).items()}
    got = tq.fill_act_scales(tower.state_dict(), calib, fp_params=fp)
    ref = port(jax.device_get(want))
    folded = [k for k in ref if k.endswith("act_smooth") and float(ref[k].max()) > 1.0]
    assert any("qkv_quant" in k for k in folded) and any("fc1" in k for k in folded)
    for k, v in ref.items():
        if k.endswith(("act_scale", "act_smooth", "weight_scale")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, err_msg=k)
        else:
            _assert_refit_codes(got[k], v, k)


def _assert_refit_codes(got, want, name):
    """Codes refitted from a calibration through a whole tower or model: the
    two forwards round their activations apart by ulps, so a code on a
    rounding boundary may move by one; at most 0.1% of them may."""
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3, (name, int((diff > 0).sum()))


def test_merge_calib_is_elementwise_max():
    a = {"x.act_amax": torch.tensor(1.0), "x.act_amax_ch": torch.tensor([1.0, 5.0])}
    b = {"x.act_amax": torch.tensor(3.0), "x.act_amax_ch": torch.tensor([2.0, 4.0])}
    got = tq.merge_calib(a, b)
    assert float(got["x.act_amax"]) == 3.0 and got["x.act_amax_ch"].tolist() == [2.0, 5.0]


def test_quantized_config_is_built_quantized():
    """serving_config("7b")-style: a decoder with quantization="int8" holds
    int8 codes in every layer's seven linears, never a float weight; the
    embeddings, norms and head stay float."""
    from hicom_tpu_torch.api import build_model

    cfg = tcfg.tiny_test_config(use_guide="direct")
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, quantization="int8"),
                      vision_config=dataclasses.replace(cfg.vision_config, quantization="w8a8"))
    model = build_model(cfg, device="cpu", seed=0)
    sd = model.state_dict()
    lin = [k for k in sd if k.startswith("model.layers.") and k.endswith(("_proj.weight", "_proj.weight_q"))]
    assert len(lin) == 7 * cfg.text_config.num_hidden_layers
    assert all(k.endswith("weight_q") and sd[k].dtype == torch.int8 for k in lin)
    assert sd["lm_head.weight"].is_floating_point() and sd["model.embed_tokens.weight"].is_floating_point()
    assert sum(isinstance(m, tq.W8A8Linear) for m in model.modules()) == 3 * 2 + 2  # out_proj, fc1, fc2 of 2 layers + the head MLP
    # the same seed draws the same float weights as the float build: the codes are the float weights' codes
    ref = build_model(cfg.replace(text_config=dataclasses.replace(cfg.text_config, quantization=None),
                                  vision_config=dataclasses.replace(cfg.vision_config, quantization=None)),
                      device="cpu", seed=0).state_dict()
    name = "model.layers.1.mlp.down_proj"
    q, s = tq.quantize_int8_weight(ref[f"{name}.weight"])
    assert torch.equal(sd[f"{name}.weight_q"], q) and torch.equal(sd[f"{name}.weight_scale"], s)
    assert torch.equal(sd["model.norm.weight"], ref["model.norm.weight"])


@pytest.mark.parametrize("where,mode", [("text", "int4"), ("text", "w8a8s+calib"), ("vision", "nf4"),
                                        ("vision", "w8a8s_mlp_qkv+calib"), ("text", True)])
def test_unknown_quantization_raises(where, mode):
    cfg = tcfg.tiny_test_config()
    key = "text_config" if where == "text" else "vision_config"
    cfg = cfg.replace(**{key: dataclasses.replace(getattr(cfg, key), quantization=mode)})
    with pytest.raises(ValueError, match="quantization"):
        TModel(cfg)
