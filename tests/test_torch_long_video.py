"""Sequence-parallel long-video encoding against the JAX package, in gloo groups.

A 32-frame video goes through ``hicom_tpu_torch.parallel.long_video
.encode_visual_sharded`` in 2 and 4 gloo rank processes (chunks of 16 and 8
frames; ``tests/torch_ranks.long_video_worker``), for the tiny model without a
guide, with the direct guide, and with the local43 and global32 projectors
alone, each from the JAX model's parameters. Every rank's tokens must equal,
at rtol = atol = 2e-5:

* JAX's ``encode_visual_sharded`` on the 8 virtual CPU devices (chunks of 4),
* JAX's single-pass ``HIComModel.encode_visual``
  (the cases of ``tests/test_parallel.py``'s long-video tests).

In this process: the attention over a key sequence split in chunks
(``sdpa(..., kv_group=)``: K2's partials per chunk, then the merge) equals
``sdpa`` over the whole sequence, with lengths that leave some chunks
without a valid key; and ``encode_visual_sharded`` without a mesh equals
``encode_visual``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks as R
from hicom_tpu.config import tiny_test_config
from hicom_tpu.models.hicom import HIComModel
from hicom_tpu.parallel import create_mesh
from hicom_tpu.parallel.long_video import encode_visual_sharded
from hicom_tpu_torch.ops import attention
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO = -201
T = 32
CASES = {"none": {}, "direct": {"use_guide": "direct"}, "local43": {"mm_projector_type": "local43"},
         "global32": {"mm_projector_type": "global32"}}
WORLDS = (2, 4)


def _init(cfg):
    """JAX parameters of ``cfg`` (jitted: an eager flax init takes several times as long)."""
    ids = np.full((1, 4), 7)
    ids[0, 1] = VIDEO
    img = cfg.vision_config.image_size
    gids = jnp.ones((1, 8), jnp.int32) if cfg.guide_enabled() else None
    model = HIComModel(config=cfg)
    return jax.jit(lambda r: model.init(r, jnp.asarray(ids), jnp.zeros((1, 4, 3, img, img)), guide_ids=gids,
                                        modal="video"))(jax.random.PRNGKey(0))["params"]


def _jax_case(overrides, params, seed):
    cfg = tiny_test_config(**overrides)
    model = HIComModel(config=cfg)
    rng = np.random.default_rng(seed)
    img = cfg.vision_config.image_size
    frames = rng.standard_normal((T, 3, img, img)).astype(np.float32)
    gids = rng.integers(1, cfg.guide_text_config.vocab_size, (1, 8)) if cfg.guide_enabled() else None

    def single(p, f, g):
        ge = None if g is None else model.apply({"params": p}, g, method=HIComModel.encode_guide)
        return ge, model.apply({"params": p}, f[None], ge, "video", method=HIComModel.encode_visual)[0]

    ge, ref = jax.jit(single)(params, jnp.asarray(frames), None if gids is None else jnp.asarray(gids))
    mesh = create_mesh(dp=8)
    with mesh:
        sharded = jax.jit(lambda p, f, g: encode_visual_sharded(model, p, f, mesh, guide_embeds=g, modal="video"))(
            params, jnp.asarray(frames), None if ge is None else ge[0])
    sd = state_dict_from_jax(jax.device_get(params))
    return (overrides, sd, frames, gids), np.asarray(ref), np.asarray(sharded)


@pytest.fixture(scope="module")
def jax_refs():
    """The four cases; local43's and global32's parameters are the guide-less
    model's without the other compressor (their trees are its subtrees)."""
    full, direct = _init(tiny_test_config()), _init(tiny_test_config(use_guide="direct"))

    def without(part):
        return {**full, "mm_projector": {k: v for k, v in full["mm_projector"].items() if k != part}}

    params = {"none": full, "direct": direct, "local43": without("global_compressor"),
              "global32": without("local_compressor")}
    return {name: _jax_case(o, params[name], seed) for seed, (name, o) in enumerate(CASES.items(), start=3)}


@pytest.fixture(scope="module")
def port(jax_refs, tmp_path_factory):
    root = tmp_path_factory.mktemp("long_video")
    torch.save({name: ref[0] for name, ref in jax_refs.items()}, root / "payload.pt")
    out = {}
    for world in WORLDS:
        R.spawn(R.long_video_worker, world, str(root / "payload.pt"), str(root / f"w{world}"))
        out[world] = [R.load(root / f"w{world}.{r}") for r in range(world)]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_encode_matches_jax(jax_refs, port, case, world):
    _, single, sharded = jax_refs[case]
    for rank, res in enumerate(port[world]):
        got = res[case].numpy()
        assert got.shape == single.shape
        np.testing.assert_allclose(got, sharded, rtol=2e-5, atol=2e-5, err_msg=f"{case} rank {rank} vs JAX sharded")
        np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-5, err_msg=f"{case} rank {rank} vs encode_visual")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_tokens_without_jax(port, world):
    first = port[world][0]
    for res in port[world]:
        assert res["no_jax"]
        for case in CASES:
            assert torch.equal(res[case], first[case]), case


@pytest.mark.parametrize("n,lens", [(2, (70, 160)), (4, (30, 160)), (5, (1, 97))])
def test_split_key_attention_equals_whole(monkeypatch, n, lens):
    """Each chunk's K2 partials with its local lengths, merged by the gather
    that ranks run in turn would give: equal to ``sdpa`` over the whole key
    sequence; the first row's length ends inside the first chunk, so the
    later chunks hold no valid key for it."""
    from hicom_tpu_torch.ops.attention import SoloGroup, sdpa
    from hicom_tpu_torch.ops.flash_attention import flash_forward_partials

    rng = np.random.default_rng(n)
    b, H, Lq, Lk, d = 2, 3, 32, 160, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, H, Lq, d), (b, H, Lk, d), (b, H, Lk, d)))
    kl = torch.tensor(lens)
    ref = sdpa(q, k, v, kv_lengths=kl, scale=0.2, logit_bias=0.3)
    c = Lk // n
    local = [(kl - i * c).clamp(0, c) for i in range(n)]
    parts = [flash_forward_partials(q, k[:, :, i * c:(i + 1) * c], v[:, :, i * c:(i + 1) * c], local[i], 0.2, 0.3)
             for i in range(n)]
    assert int(local[-1][0]) == 0  # a chunk with no valid key for row 0
    monkeypatch.setattr(attention, "gather_partials", lambda own, group: tuple(torch.cat(t) for t in zip(*parts)))
    got = sdpa(q, k[:, :, :c], v[:, :, :c], kv_lengths=local[0], scale=0.2, logit_bias=0.3, kv_group=SoloGroup())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["none", "direct"])
def test_one_process_without_a_mesh_equals_encode_visual(jax_refs, case):
    from hicom_tpu_torch.parallel.long_video import encode_visual_sharded as sharded

    (overrides, sd, frames, gids), single, _ = jax_refs[case]
    model = R._tiny_model(overrides, sd)
    f = torch.from_numpy(frames)
    with torch.no_grad():
        ge = model.encode_guide(torch.as_tensor(gids)) if gids is not None else None
        ref = model.encode_visual(f[None], ge)[0]
    got = sharded(model, f, None, guide_embeds=ge[0] if ge is not None else None)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), single, rtol=2e-5, atol=2e-5)
