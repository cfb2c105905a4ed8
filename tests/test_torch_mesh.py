"""The port's mesh, sharding rules and multi-process data against the JAX package's.

* Every parameter of the tiny guide-mode model and of HICom-7B's shapes
  (Qwen2.5-7B, so400m, its text encoder, local43_global32; 2 layers each,
  since the rules read names and shapes, not depth) gets from the port's
  rules the spec JAX's ``spec_for_path`` gives its counterpart (matched
  through ``state_dict_from_jax``), transposed to torch's (out, in) layout,
  on the meshes (2,2,2), (1,2,4), (8,1,1) and (1,1,8).
* ``param_shardings`` (what the port places) departs from them only as
  ``parallel/sharding.py`` documents: a column-parallel Linear's bias is
  split on tp with its rows, and an attention block whose heads do not
  divide by tp stays replicated whole. At tp 8 that is Qwen2.5-7B's
  attention (28 query and 4 KV heads), whose k/v columns (512) XLA splits.
* ``create_mesh``'s ``dp=None`` rule and its refusals; a mesh larger than
  the world of one process is refused.
* ``iter_batches``' slices for 2 and 4 processes and the collator's fixed
  shapes equal JAX's, batch for batch.
"""

import jax
import numpy as np
import pytest
import torch

from hicom_tpu.parallel import sharding as jsharding
from hicom_tpu.parallel.mesh import create_mesh as jax_mesh
from hicom_tpu.train import dataset as jds
from hicom_tpu_torch.parallel import mesh as tmesh
from hicom_tpu_torch.parallel import sharding as tsharding
from hicom_tpu_torch.train import dataset as tds

MESHES = [(2, 2, 2), (1, 2, 4), (8, 1, 1), (1, 1, 8)]


def _name_map():
    """({torch name: JAX path} of the tiny guide-mode model, the torch model)."""
    import jax.numpy as jnp

    from hicom_tpu.config import tiny_test_config as jtiny
    from hicom_tpu.models.hicom import HIComModel as JModel
    from hicom_tpu_torch.config import tiny_test_config
    from hicom_tpu_torch.models.hicom import HIComModel

    cj = jtiny(use_guide="direct")
    ids = jnp.zeros((1, 8), jnp.int32).at[0, 2].set(-201)
    frames = jnp.zeros((1, 4, 3, cj.vision_config.image_size, cj.vision_config.image_size))
    shapes = jax.eval_shape(lambda r: JModel(config=cj).init(r, ids, frames, guide_ids=jnp.ones((1, 4), jnp.int32)),
                            jax.random.PRNGKey(0))["params"]
    from hicom_tpu_torch.weights import state_dict_from_jax
    from test_torch_train import _torch_to_jax_path

    to_jax = _torch_to_jax_path(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    # which tensors the name map transposes: each leaf holds its own element order
    order = state_dict_from_jax(jax.tree.map(lambda s: np.arange(np.prod(s.shape)).reshape(s.shape), shapes))
    transposed = {n: not torch.equal(t.reshape(-1), torch.arange(t.numel())) for n, t in order.items()}
    return to_jax, transposed, HIComModel(tiny_test_config(use_guide="direct"))


@pytest.fixture(scope="module")
def models():
    """[(torch model, {torch name: (JAX path, JAX shape)})] for the tiny model and HICom-7B's shapes."""
    import dataclasses

    from hicom_tpu_torch.config import HIComConfig, Qwen2Config, SiglipTextConfig, SiglipVisionConfig
    from hicom_tpu_torch.models.hicom import HIComModel

    to_jax, transposed, tiny = _name_map()
    cfg = HIComConfig(text_config=dataclasses.replace(Qwen2Config(), num_hidden_layers=2),
                      vision_config=dataclasses.replace(SiglipVisionConfig(), num_hidden_layers=2),
                      guide_text_config=dataclasses.replace(SiglipTextConfig(), num_hidden_layers=2),
                      mm_vision_tower="google/siglip-so400m-patch14-384", mm_projector_type="local43_global32",
                      use_guide="direct", dtype="bfloat16")
    with torch.device("meta"):
        big = HIComModel(cfg)
    out = []
    for model in (tiny, big):
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert set(shapes) == set(to_jax)
        # JAX's layout: a Linear's weight is (in, out) there (the map transposes it); a conv
        # kernel's ranks take no rule but replication, so its order does not matter here
        assert all(len(shapes[n]) == 2 for n, t in transposed.items() if t and len(shapes[n]) != 4)
        out.append((model, {n: (to_jax[n], s[::-1] if transposed[n] and len(s) == 2 else s, transposed[n])
                            for n, s in shapes.items()}))
    return out


def _jax_spec(path, shape, mesh, transposed):
    spec = _padded(jsharding.spec_for_path(path, shape, mesh), len(shape))
    return spec[::-1] if transposed and len(shape) == 2 else spec


def _padded(spec, ndim):
    return (tuple(spec) + (None,) * ndim)[:ndim]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_rules_match_jax(models, shape):
    jmesh = jax_mesh(*shape)
    sizes = dict(zip(tmesh.MESH_AXES, shape))
    for model, names in models:
        n_tp = 0
        for name, (path, jshape, transposed) in names.items():
            tshape = tuple(model.get_parameter(name).shape)
            got = _padded(tsharding.spec_for_path(name, tshape, sizes), len(tshape))
            assert got == _jax_spec(path, jshape, jmesh, transposed), (name, path)
            n_tp += "tp" in got
        assert n_tp > 0 or sizes["tp"] == 1


def _whole_blocks(model, tp):
    """Attention blocks whose heads do not divide by tp, from the configs."""
    cfg = model.hicom_config
    out = set()
    if cfg.text_config.num_attention_heads % tp or cfg.text_config.num_key_value_heads % tp:
        out |= {f"model.layers.{i}.self_attn" for i in range(cfg.text_config.num_hidden_layers)}
    for prefix, c in (("model.vision_tower.vision_tower.vision_model", cfg.vision_config),
                      ("model.vision_tower.guide_encoder.text_model", cfg.guide_text_config)):
        if c.num_attention_heads % tp:
            out |= {f"{prefix}.encoder.layers.{i}.self_attn" for i in range(c.num_hidden_layers)}
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_placements_depart_from_jax_only_as_documented(models, shape):
    jmesh = jax_mesh(*shape)
    sizes = dict(zip(tmesh.MESH_AXES, shape))
    tp = sizes["tp"]
    for model, names in models:
        placed = tsharding.param_shardings(model, sizes)
        whole = _whole_blocks(model, tp)
        plan = tsharding.tp_plan(model, sizes)
        for name, (path, jshape, transposed) in names.items():
            ndim = len(model.get_parameter(name).shape)
            want, got = _jax_spec(path, jshape, jmesh, transposed), _padded(placed[name], ndim)
            owner, leaf = name.rsplit(".", 2)[0], name.rsplit(".", 1)[1]
            if owner in whole:  # a kernel cannot take half a head: the block stays whole on tp
                want = tuple(None if a == "tp" else a for a in want)
            if leaf == "bias" and name[:-len(".bias")] in plan and plan[name[:-len(".bias")]] == "colwise":
                want = ("tp",)  # a column-parallel Linear's bias goes with its rows
            assert got == want, (name, path, got, want)
        assert set(plan.values()) == {"colwise", "rowwise"}


def test_qwen7b_attention_at_tp8_is_the_documented_departure(models):
    """XLA splits k/v's 512 columns and q's 3,584 on tp 8; the port keeps the
    whole attention block replicated (4 KV heads, 28 query heads: no whole
    head per rank), and splits the MLP."""
    model, names = models[1]
    jmesh = jax_mesh(1, 1, 8)
    placed = tsharding.param_shardings(model, {"dp": 1, "fsdp": 1, "tp": 8})
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        name = f"model.layers.0.self_attn.{proj}.weight"
        assert "tp" in jsharding.spec_for_path(names[name][0], names[name][1], jmesh)
        assert "tp" not in placed[name]
    assert placed["model.layers.0.mlp.gate_proj.weight"] == ("tp", "fsdp")
    assert placed["model.layers.0.mlp.down_proj.weight"] == ("fsdp", "tp")
    # at tp 4 the heads divide (7 and 1 per rank): the port splits attention as XLA does
    placed4 = tsharding.param_shardings(model, {"dp": 1, "fsdp": 2, "tp": 4})
    assert placed4["model.layers.0.self_attn.k_proj.weight"] == ("tp", "fsdp")
    assert placed4["model.layers.0.self_attn.k_proj.bias"] == ("tp",)


def test_mesh_shape_rule_and_refusals(monkeypatch):
    assert tmesh._mesh_shape(8, None, 2, 2) == (2, 2, 2)
    assert tmesh._mesh_shape(8, None, 1, 1) == (8, 1, 1)
    assert tmesh._mesh_shape(4, 1, 2, 2) == (1, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh._mesh_shape(6, None, 4, 1)
    with pytest.raises(ValueError, match="!= 8 ranks"):
        tmesh._mesh_shape(8, 2, 2, 1)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        tmesh.init_distributed("cpu", dp=2)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        tmesh.init_distributed("cpu")  # even one rank needs torchrun's environment for a mesh
    tmesh.check_world()  # (1, 1, 1) fits the one process


def test_create_mesh_over_one_process(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = tmesh.create_mesh()
        assert mesh.mesh_dim_names == tmesh.MESH_AXES and tuple(mesh.shape) == (1, 1, 1)
        assert tmesh.data_coordinate(mesh) == (0, 1)
        assert tuple(tmesh.single_device_mesh().shape) == (1, 1, 1)
        with pytest.raises(ValueError):
            tmesh.create_mesh(2)
        t = torch.ones(())
        assert float(tmesh.all_reduce_data(t, mesh)) == 1.0
        b = {"input_ids": np.arange(8).reshape(4, 2), "modal": "video"}
        sliced = tsharding.shard_batch_tree(b, mesh)
        assert sliced["modal"] == "video" and np.array_equal(sliced["input_ids"], b["input_ids"])
    finally:
        dist.destroy_process_group()


def test_batch_rows_follow_the_data_coordinate(monkeypatch):
    """``data_rows`` is the one slice of a global batch: ``iter_batches``
    collates it and ``shard_batch_tree`` cuts it by the data coordinate."""
    whole = {"input_ids": np.arange(16).reshape(8, 2), "modal": "video"}
    for index, count, want in ((0, 2, slice(0, 4)), (1, 2, slice(4, 8)), (3, 4, slice(6, 8))):
        assert tmesh.data_rows(8, index, count) == want
        monkeypatch.setattr(tsharding, "data_coordinate", lambda mesh, i=index, c=count: (i, c))
        got = tsharding.shard_batch_tree(whole, object())
        assert got["modal"] == "video" and np.array_equal(got["input_ids"], whole["input_ids"][want])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.data_rows(6, 0, 4)
    x = torch.ones(3)
    assert tsharding.constrain_batch_activation(x) is x


def test_iter_batches_slices_and_fixed_shapes_match_jax(tmp_path):
    from test_torch_data import _both, _same_items

    (jd, jc), (td, tc) = _both(tmp_path, use_guide="direct")
    assert jd.max_image_crops == td.max_image_crops and jd.has_multi_image == td.has_multi_image
    for fixed in (False, True):
        if fixed:
            for c, d in ((jc, jd), (tc, td)):
                c.fixed_length = 32
                c.fixed_frames = {"video": 8, "image": d.max_image_crops}
                c.fixed_multi_image = d.has_multi_image
        for count in (2, 4):
            for index in range(count):
                jb = list(jds.iter_batches(jd, jc, 4, seed=3, process_index=index, process_count=count))
                tb = list(tds.iter_batches(td, tc, 4, seed=3, process_index=index, process_count=count))
                assert len(jb) == len(tb) > 0
                for a, b in zip(jb, tb):
                    _same_items(a, b)
                    assert len(b["input_ids"]) == 4 // count
                    if fixed:
                        assert b["input_ids"].shape[1] == 32
                        assert b["frames"].shape[1] == (8 if b["modal"] == "video" else td.max_image_crops)
    with pytest.raises(ValueError, match="not divisible"):
        next(tds.iter_batches(td, tc, 3, process_index=0, process_count=2))
