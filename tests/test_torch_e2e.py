"""The slice end to end on the CPU: the port's greedy ids equal the JAX
package's ``generate_tokens`` on a tiny model whose weights go through
``state_dict_from_jax``: a video prompt, an image prompt, a right-padded batch
of 2, and a keyword stop sequence.

Greedy ids are compared exactly: fp32 logits of the two packages differ by
~1e-6 while random-weight logits are separated by far more, so argmax agrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.generate import generate_tokens as j_generate
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.generate import generate_tokens as t_generate
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO = -201
IMAGE = -200


@pytest.fixture(scope="module")
def pair():
    cj = jcfg.tiny_test_config(use_guide="direct")
    ct = tcfg.tiny_test_config(use_guide="direct")
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 500, (1, 10))
    ids[0, 2] = VIDEO
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    gids = rng.integers(1, 250, (1, 16))
    jm = JModel(config=cj)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(frames),
                     guide_ids=jnp.asarray(gids))["params"]
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params), ct), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("case", ["video", "image", "padded_batch", "stop_sequence"])
def test_greedy_ids_match_jax(pair, case):
    jm, params, tm = pair
    rng = np.random.default_rng({"video": 1, "image": 2, "padded_batch": 3, "stop_sequence": 1}[case])
    b = 2 if case == "padded_batch" else 1
    t = 1 if case == "image" else 4
    modal = "image" if case == "image" else "video"
    ids = rng.integers(3, 500, (b, 14))
    ids[:, 3] = IMAGE if case == "image" else VIDEO
    mask = None
    if case == "padded_batch":
        mask = np.ones((b, 14), bool)
        mask[1, 9:] = False
        ids[1, 9:] = 0
    frames = rng.standard_normal((b, t, 3, 56, 56)).astype(np.float32)
    gids = rng.integers(1, 250, (b, 16))
    kw = dict(modal=modal, max_new_tokens=8, eos_token_id=2, cache_len=128)
    if case == "stop_sequence":  # the video case's 3rd and 4th tokens as a keyword: stops at step 3
        kw["stop_sequences"] = ((148, 250),)
    ref = j_generate({"params": params}, jnp.asarray(ids), jnp.asarray(frames), jnp.asarray(gids), None,
                     jax.random.PRNGKey(0), None if mask is None else jnp.asarray(mask), model=jm, **kw)
    got = t_generate(tm, torch.from_numpy(ids), torch.from_numpy(frames), torch.from_numpy(gids), None,
                     None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "stop_sequence":
        assert (np.asarray(ref)[0, 4:] == 2).all() and (np.asarray(ref)[0, :4] != 2).all()
