"""Tensor-parallel serving: the port's ``ServeEngine(mesh=...)`` in gloo ranks against JAX's.

``tests/test_serve.py``'s mesh case, on its tiny model (weights carried by
``state_dict_from_jax``, fp32) and ``tests/test_torch_serve.py``'s four mixed
video/text requests (2 slots, so slots refill). JAX's ``ServeEngine(mesh=
create_mesh(dp=1, tp=2|4, devices=jax.devices()[:2|4]))`` runs on its virtual
CPU devices; the port's runs in 4 gloo rank processes
(``tests/torch_ranks.mesh_serve_worker``), at tp 2 on a (2, 1, 2) mesh (two tp
groups serving side by side) and at tp 4 on (1, 1, 4), where the tiny
decoder's 2 KV heads do not divide: its attention and cache stay whole and
its MLPs split. Greedy streams must equal JAX's sharded engine's and the
port's unsharded engine's exactly; a ``spec_k=3`` engine at tp 2 must give
the plain streams; a sampled one (temperature 0.7) the same streams on every
rank; the caller's model must be left as it was.
"""

import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from hicom_tpu.parallel.mesh import create_mesh as jax_mesh
from hicom_tpu.serve import GenRequest as JRequest
from hicom_tpu.serve import ServeEngine as JEngine
from test_torch_serve import EOS, MIXED, setup  # noqa: F401  (setup: the module's model fixture)

WORLD = 4
BASE = dict(n_slots=2, cache_len=128, prompt_buckets=(12, 16), sync_steps=3, eos_token_id=EOS)
CASES = {"tp2": ((2, 1, 2), BASE), "tp4": ((1, 1, 4), BASE),
         "tp2_spec": ((2, 1, 2), dict(BASE, spec_k=3, spec_max_active=2, spec_min_accept=0.0)),
         "tp2_sampled": ((2, 1, 2), dict(BASE, temperature=0.7, seed=0))}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("mesh_serve")
    sd = {k: v.clone() for k, v in setup[2].state_dict().items()}
    torch.save(dict(state_dict=sd, requests=MIXED, cases=CASES, unsharded=BASE), root / "payload.pt")
    R.spawn(R.mesh_serve_worker, WORLD, str(root / "payload.pt"), str(root / "out"))
    return [R.load(root / f"out.{r}") for r in range(WORLD)]


@pytest.fixture(scope="module")
def unsharded(setup):  # noqa: F811
    return R._serve(setup[2], MIXED, **BASE)[0]


def jax_streams(setup, tp):  # noqa: F811
    jm, variables, _ = setup
    eng = JEngine(jm, variables, mesh=jax_mesh(dp=1, tp=tp, devices=jax.devices()[:tp]), **BASE)
    ids = [eng.submit(JRequest(**r)) for r in MIXED]
    res = eng.run()
    return [res[i].tokens.tolist() for i in ids]


@pytest.mark.parametrize("tp", [2, 4])
def test_streams_equal_jax_mesh_engine_and_unsharded(setup, ranks, unsharded, tp):  # noqa: F811
    want = jax_streams(setup, tp)
    assert want == unsharded
    for res in ranks:
        assert res["no_jax"]
        assert res[f"tp{tp}"]["streams"] == want
        assert res[f"tp{tp}"]["collectives"] > 0


def test_split_blocks_and_cache_heads(ranks):
    """tp 2 splits every block and the cache (1 of the 2 KV heads a rank);
    at tp 4 the decoder's attention and the cache stay whole."""
    for res in ranks:
        assert res["tp2"]["kv_heads"] == 1
        assert res["tp2"]["split"] == {"attention": True, "mlp": True, "tower": True, "lm_head": True}
        assert res["tp4"]["kv_heads"] == 2
        assert res["tp4"]["split"] == {"attention": False, "mlp": True, "tower": True, "lm_head": True}


def test_spec_engine_at_tp2_equals_plain(ranks):
    for res in ranks:
        assert res["tp2_spec"]["spec_rounds"] > 0
        assert res["tp2_spec"]["streams"] == res["tp2"]["streams"]


def test_sampled_streams_agree_on_every_rank(ranks):
    sampled = ranks[0]["tp2_sampled"]["streams"]
    assert sampled != ranks[0]["tp2"]["streams"] and all(map(len, sampled))
    for res in ranks[1:]:
        assert res["tp2_sampled"]["streams"] == sampled


def test_caller_model_left_whole(ranks, unsharded):
    """After four engines with a mesh were built on it, the caller's model
    holds its tensors bit for bit and an engine without a mesh gives the
    unsharded streams."""
    for res in ranks:
        assert res["unchanged"]
        assert res["unsharded"] == unsharded
