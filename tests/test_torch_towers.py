"""Port towers and projector vs the JAX modules, weights carried by state_dict_from_jax.

Tiny configs, inputs from numpy seeds, fp32 on the CPU. Tolerance 1e-4
(absolute and relative): a few fp32 layers of matmuls, layer norms and
softmaxes summed in another order drift by a few ulps per layer; the values
compared are O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.projector import HIComProjector as JProjector
from hicom_tpu.models.siglip import SiglipTextEncoder as JText
from hicom_tpu.models.siglip import SiglipVisionTower as JVision
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.projector import HIComProjector as TProjector
from hicom_tpu_torch.models.siglip import SiglipTextEncoder as TText
from hicom_tpu_torch.models.siglip import SiglipVisionTower as TVision
from hicom_tpu_torch.weights import state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def _load(module, jax_params, top, prefix):
    sd = state_dict_from_jax({top: jax.device_get(jax_params)})
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_siglip_vision_tower_matches_jax():
    cfg_j, cfg_t = jcfg.tiny_test_config().vision_config, tcfg.tiny_test_config().vision_config
    rng = np.random.default_rng(0)
    px = rng.uniform(-1, 1, (3, 3, 56, 56)).astype(np.float32)
    jm = JVision(config=cfg_j, select_layer=-2, with_head=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"]
    jf, je = jm.apply({"params": params}, jnp.asarray(px))
    tm = _load(TVision(cfg_t, -2, with_head=True, dtype=torch.float32), params, "vision_tower",
               "model.vision_tower.vision_tower.")
    with torch.no_grad():
        tf, te = tm(torch.from_numpy(px))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


def test_siglip_text_encoder_matches_jax():
    cfg_j, cfg_t = jcfg.tiny_test_config().guide_text_config, tcfg.tiny_test_config().guide_text_config
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg_j.vocab_size, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 11:] = 0
    jm = JText(config=cfg_j)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    tm = _load(TText(cfg_t, dtype=torch.float32), params, "guide_encoder", "model.vision_tower.guide_encoder.")
    for m in (None, mask):
        jp, jt = jm.apply({"params": params}, jnp.asarray(ids), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            tp, tt = tm(torch.from_numpy(ids), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


PROJECTOR_CASES = {
    "direct": dict(use_guide="direct"),
    "coarse_adapters": dict(use_guide="coarse", mm_projector_type="local43adaptqkvg_global32adaptg"),
    "fine": dict(use_guide="fine"),
    "clip_scale": dict(use_guide="direct", use_clip_scale="local,global"),
    "no_guide": dict(use_guide=None),
}


@pytest.mark.parametrize("case", sorted(PROJECTOR_CASES))
@pytest.mark.parametrize("thw", [(8, 9, 9), (4, 4, 4)])  # divisible tiles and the overlap fallback
def test_projector_matches_jax(case, thw):
    kw = PROJECTOR_CASES[case]
    cj, ct = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    rng = np.random.default_rng(len(case) + sum(thw))
    b, d = 2, cj.mm_hidden_size
    ff = rng.standard_normal((b, *thw, d)).astype(np.float32)
    fe = rng.standard_normal((b, *thw, cj.qk_dim)).astype(np.float32)
    gshape = (b, 6, cj.qk_dim) if kw["use_guide"] == "fine" else (b, cj.qk_dim)
    ge = rng.standard_normal(gshape).astype(np.float32) if kw["use_guide"] else None
    jp = JProjector(config=cj)
    params = jp.init(jax.random.PRNGKey(2), jnp.asarray(ff[0]), jnp.asarray(fe[0]),
                     None if ge is None else jnp.asarray(ge[0]), "video")["params"]
    # non-zero clip scales and global queries, so those paths carry signal
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 if any(getattr(k, "key", "") in ("local_logit_scale", "global_logit_scale", "query")
                                    for k in p) else x, params)
    ref = np.stack([
        np.asarray(jp.apply({"params": params}, jnp.asarray(ff[i]), jnp.asarray(fe[i]),
                            None if ge is None else jnp.asarray(ge[i]), "video"))
        for i in range(b)])
    tp = _load(TProjector(ct, dtype=torch.float32), params, "mm_projector", "model.mm_projector.")
    with torch.no_grad():
        got = tp(torch.from_numpy(ff), torch.from_numpy(fe), None if ge is None else torch.from_numpy(ge), "video")
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
