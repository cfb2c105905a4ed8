"""Rank processes for the port's mesh tests: gloo groups on the CPU.

``spawn(fn, world, *args)`` starts ``world`` fresh interpreters (the spawn
start method, one torch thread each), joins them into a gloo group on a free
localhost port and calls ``fn(rank, *args)`` in each; a rank that raises
fails the call. This module imports neither JAX nor the JAX package, so a
rank process holds only the port (``test_torch_hygiene`` checks it).

``train_worker`` takes the port's sharded train steps on the tiny model that
:func:`build` makes, for the cases ``tests/test_torch_mesh_train.py`` holds
to the unsharded step. :class:`Torchrun` starts the port's CLI (or the eval
runner) under ``python -m torch.distributed.run`` in the background. The
workers at the end serve tensor-parallel (``mesh_serve_worker``) and split
eval batches (``eval_dp_worker``).
"""

import os
import socket
import subprocess
import sys
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO, IGNORE = -201, -100
TUNABLE = "mm_projector,language_model"  # a trained decoder (tp-split) beside a frozen tower and guide encoder


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, args):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``world`` gloo rank processes; raises if any fails."""
    import torch.multiprocessing as mp

    for path in (REPO, os.path.dirname(os.path.abspath(__file__))):
        if path not in sys.path:
            sys.path.insert(0, path)
    mp.start_processes(_entry, args=(fn, world, free_port(), args), nprocs=world, join=True, start_method="spawn")


def batches(cfg, steps: int = 2, rows: int = 4, seed: int = 0):
    """``steps`` global batches of ``rows`` video rows: 12 ids with a <video>
    sentinel, right padding and ignored labels that leave each row a different
    number of targets (the second half of a batch far fewer), guide ids."""
    rng = np.random.default_rng(seed)
    out = []
    size = cfg.vision_config.image_size
    for _ in range(steps):
        ids = rng.integers(3, cfg.text_config.vocab_size, (rows, 12))
        ids[:, 2] = VIDEO
        mask = np.ones((rows, 12), bool)
        for r in range(rows):
            mask[r, 12 - 2 * (r % 4):] = False
        ids[~mask] = 0
        labels = np.where(mask, ids, IGNORE)
        labels[:, :3] = IGNORE
        labels[rows // 2:, 3:6] = IGNORE
        b = dict(input_ids=ids, attention_mask=mask, labels=labels,
                 frames=rng.standard_normal((rows, 4, 3, size, size)).astype(np.float32))
        if cfg.guide_enabled():
            b["guide_ids"] = rng.integers(1, cfg.guide_text_config.vocab_size, (rows, 16))
        out.append(b)
    return out


def build(remat: bool = False, max_grad_norm: float = 1.0, seed: int = 0):
    """(model, optimizer, batches): the tiny guide-mode model in fp32 from
    ``seed``, its decoder and projector trained."""
    import dataclasses

    from hicom_tpu_torch.config import tiny_test_config
    from hicom_tpu_torch.models.hicom import HIComModel
    from hicom_tpu_torch.train.optimizer import build_optimizer

    cfg = tiny_test_config(use_guide="direct")
    if remat:
        cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True))
    torch.manual_seed(seed)
    model = HIComModel(cfg)
    opt = build_optimizer(model, learning_rate=1e-3, total_steps=10, warmup_ratio=0.0, schedule_kind="constant",
                          tunable_parts=TUNABLE, use_guide="direct", max_grad_norm=max_grad_norm, weight_decay=0.1)
    return model, opt, batches(cfg)


def run_steps(state, batch_list, mesh=None, save_to=None):
    """Train ``batch_list`` (each rank on its slice over ``mesh``); returns the
    per-step loss, grad norm and target tokens. ``save_to``: checkpoint there
    after the first step."""
    from hicom_tpu_torch.parallel.sharding import shard_batch_tree
    from hicom_tpu_torch.train.checkpoints import save_checkpoint
    from hicom_tpu_torch.train.train_step import make_train_step

    step = make_train_step(modal="video")
    out = {"loss": [], "grad_norm": [], "target_tokens": []}
    for i, b in enumerate(batch_list):
        state, m = step(state, shard_batch_tree(b, mesh) if mesh is not None else b)
        for k in out:
            out[k].append(float(m[k]))
        if save_to is not None and i == 0:
            save_checkpoint(save_to, state)
    return out


def sharded_case(case: dict) -> dict:
    """One case of ``train_worker``: the steps' metrics, the whole masters,
    the frozen tensors that moved, q_proj's local and whole sizes."""
    from hicom_tpu_torch.parallel.mesh import create_mesh
    from hicom_tpu_torch.parallel.sharding import local
    from hicom_tpu_torch.train.train_step import create_sharded_state

    mesh = create_mesh(*case["shape"], device_type="cpu")
    model, opt, batch_list = build(case.get("remat", False), case.get("max_grad_norm", 1.0))
    trained = {n for n, lab in opt.labels.items() if lab != "frozen"}
    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters() if n not in trained}
    state = create_sharded_state(model, opt, mesh, "cpu")
    q = dict(model.named_parameters())["model.layers.0.self_attn.q_proj.weight"]
    out = run_steps(state, batch_list, mesh, case.get("save_to"))
    out["q_proj_numel"] = (local(q).numel(), q.numel())
    out["q_proj_master_numel"] = opt.masters["model.layers.0.self_attn.q_proj.weight"].numel()
    out["masters"] = opt.state_dict()["masters"]
    params = dict(model.named_parameters())
    out["frozen_moved"] = [n for n, before in frozen_before.items()
                           if not torch.equal(params[n].detach().full_tensor(), before)]
    out["frozen_count"] = len(frozen_before)
    out["no_jax"] = not any(m.split(".")[0] in ("jax", "jaxlib", "hicom_tpu") for m in sys.modules)
    if case.get("roundtrip"):
        out["roundtrip"] = roundtrip(state, case["roundtrip"])
    return out


class DeviceWholes(TorchDispatchMode):
    """The most storages of a whole tensor's size (``whole_bytes``) that ops
    made under the watch and that were alive at once. A rank's device is the
    CPU here, so a copy to the CPU (``aten._to_copy`` with ``device=cpu``)
    stands for a copy off the device and is not counted."""

    def __init__(self, whole_bytes):
        super().__init__()
        self.whole_bytes, self.made, self.most = set(whole_bytes), [], 0
        self.host = set()  # storage addresses on the host: a loaded checkpoint's
        self.loading = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        to_host = func is torch.ops.aten._to_copy.default and (kwargs or {}).get("device") == torch.device("cpu")
        if not (to_host or self.loading):  # (tensor, its storage's address) of each whole-sized output; a wrapper's inner tensor is one
            self.made += [(weakref.ref(t), t.untyped_storage().data_ptr()) for t in pytree.tree_leaves(out)
                          if type(t) is torch.Tensor and t.untyped_storage().nbytes() in self.whole_bytes]
        self.made = [(r, ptr) for r, ptr in self.made if r() is not None and ptr not in self.host]
        self.most = max(self.most, len({ptr for _, ptr in self.made}))
        return out

    def load(self, real_load):
        """``torch.load`` for the watch: the file's tensors are host memory
        (mapped: the call must pass ``mmap=True``), and so are their views."""

        def load(*args, **kwargs):
            self.mapped = kwargs.get("mmap", False)
            self.loading = True
            try:
                payload = real_load(*args, **kwargs)
            finally:
                self.loading = False
            self.host |= {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(payload)
                          if isinstance(t, torch.Tensor)}
            return payload

        return load


def roundtrip(state, root: str) -> dict:
    """Save ``state`` (sharded) and gather its parameters under a
    :class:`DeviceWholes` watch, restore the checkpoint into a fresh sharded
    state under another, and compare the two states' local parts."""
    from hicom_tpu_torch.parallel.sharding import local
    from hicom_tpu_torch.train.checkpoints import restore_checkpoint, save_checkpoint
    from hicom_tpu_torch.train.train_step import create_sharded_state

    opt = state.optimizer
    params = dict(state.model.named_parameters())
    sharded = [n for n in params if local(params[n]).numel() < params[n].numel()]
    # the byte sizes of whole tensors that no shard or partial gather (1/k of a whole) shares, so that
    # only a whole tensor counts as one
    world = dist.get_world_size()
    parts = {params[n].numel() * 4 // k for n in sharded for k in range(2, world + 1)}
    whole_bytes = {params[n].numel() * 4 for n in sharded} - parts - {local(p).numel() * 4 for p in params.values()}
    watched = sum(params[n].numel() * 4 in whole_bytes for n in sharded)
    save = DeviceWholes(whole_bytes)
    with save:
        save_checkpoint(root, state)
        gathered = state.params()
        sd = opt.state_dict()
    model, fresh, _ = build()
    again = create_sharded_state(model, fresh, state.mesh, "cpu")
    restore, real_load = DeviceWholes(whole_bytes), torch.load
    torch.load = restore.load(real_load)
    try:
        with restore:
            restore_checkpoint(root, again)
    finally:
        torch.load = real_load
    same = (fresh.count == opt.count and torch.equal(fresh.flat, opt.flat)
            and all(torch.equal(fresh.home.bufs[k], opt.home.bufs[k]) for k in opt.home.bufs)
            and all(torch.equal(local(p), local(params[n])) for n, p in model.named_parameters()))
    mine = dict(save_most=save.most, restore_most=restore.most, mapped=restore.mapped, same=same,
                maps=(len(gathered), len(sd["masters"]), len(sd["exp_avg"])))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return dict(ranks=ranks, sharded=len(sharded), watched=watched, params=len(params), trained=len(opt.masters))


def train_worker(rank: int, cases: list, out_path: str) -> None:
    results = {case["name"]: sharded_case(case) for case in cases}
    if rank == 0:
        torch.save(results, out_path)


class Torchrun:
    """``python -m torch.distributed.run --standalone`` of the port's CLI (or
    of ``module``) with ``flags`` in ``nproc`` gloo ranks (one torch thread
    each), started in the background with its output in ``log``; :meth:`wait`
    returns its exit code and output."""

    def __init__(self, nproc: int, flags, log: str, module: str = "hicom_tpu_torch.train.cli"):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
               "-m", module, *flags]
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        self.log = open(log, "w+")
        # a session of its own: torchrun's signals to its workers never reach this process
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)

    def wait(self, timeout: float = 600):
        rc = self.proc.wait(timeout=timeout)
        self.log.seek(0)
        return rc, self.log.read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def hygiene_worker(rank: int, out_path: str) -> None:
    """One sharded step at (1, 2, 1), then: the modules this rank process has
    imported from JAX or its package, and what each kernel wrapper does with
    a DTensor operand."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from hicom_tpu_torch.ops.flash_attention import flash_backward, flash_forward, fullblock_attention, merge_partials
    from hicom_tpu_torch.ops.flash_decode import flash_decode
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention
    from hicom_tpu_torch.parallel.mesh import create_mesh

    sharded_case(dict(name="hygiene", shape=(1, 2, 1)))
    mesh = create_mesh(1, 2, 1, device_type="cpu")
    x = torch.ones(1, 2, 16, 8)
    d = distribute_tensor(x, mesh["fsdp"], [Replicate()])
    calls = {"K1": lambda: fullblock_attention(d[0], x[0], x[0], 0.3),
             "K2": lambda: flash_forward(x, d, x, None, 0.3),
             "K5/K6": lambda: flash_backward(x, x, x, None, d, torch.zeros(1, 2, 16), x, 0.3),
             "K3": lambda: flash_decode(x[:, :, :1], x, x, d[:, 0, :, 0] > 0),
             "K4": lambda: fused_tile_attention(torch.ones(1, 1, 1, 8), d[0, :1, :4].reshape(4, 1, 1, 8),
                                                x[0, :1, :4].reshape(4, 1, 1, 8), (4, 1, 1), 0.3),
             "merge": lambda: merge_partials(d, x[:, :, :, 0], x[:, :, :, 0], torch.float32)}
    raised = {}
    for kid, call in calls.items():
        try:
            call()
            raised[kid] = None
        except TypeError as e:
            raised[kid] = str(e)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hicom_tpu"))
    if rank == 0:
        torch.save({"bad": bad, "raised": raised}, out_path)


# ---------------------------------------------------------------------------
# Sequence-parallel inference: each worker takes a payload file the test
# process wrote (configs, state dicts made from JAX's parameters, inputs) and
# writes this rank's results to ``<out_path>.<rank>``.
# ---------------------------------------------------------------------------


def _tiny_model(overrides: dict, state_dict):
    from hicom_tpu_torch.config import tiny_test_config
    from hicom_tpu_torch.models.hicom import HIComModel

    model = HIComModel(tiny_test_config(**overrides))
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def load(path: str):
    """A payload or result file of these workers (numpy arrays and tensors)."""
    return torch.load(path, weights_only=False)


def _save_rank(results: dict, out_path: str, rank: int) -> None:
    results["no_jax"] = not any(m.split(".")[0] in ("jax", "jaxlib", "hicom_tpu") for m in sys.modules)
    torch.save(results, f"{out_path}.{rank}")


def long_video_worker(rank: int, payload_path: str, out_path: str) -> None:
    """``encode_visual_sharded`` over a (world, 1, 1) mesh for each case of
    the payload: {name: (config overrides, state dict, frames, guide ids)}."""
    from hicom_tpu_torch.parallel.long_video import encode_visual_sharded
    from hicom_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(dp=dist.get_world_size(), device_type="cpu")
    results = {}
    for name, (overrides, sd, frames, gids) in load(payload_path).items():
        model = _tiny_model(overrides, sd)
        with torch.no_grad():
            ge = model.encode_guide(torch.as_tensor(gids))[0] if gids is not None else None
        results[name] = encode_visual_sharded(model, torch.as_tensor(frames), mesh, guide_embeds=ge)
    _save_rank(results, out_path, rank)


def ring_worker(rank: int, payload_path: str, out_path: str) -> None:
    """``ring_self_attention`` on the payload's whole q/k/v for each mask
    case, ``ring_prefill`` of its embeddings, and ``HICom.generate`` routed to
    the ring prefill (``HICOM_RING_PREFILL_MIN=1``), all over the mesh's dp
    axis."""
    from hicom_tpu_torch.api import HICom
    from hicom_tpu_torch.parallel.mesh import create_mesh
    from hicom_tpu_torch.parallel.ring import ring_prefill, ring_self_attention

    p = load(payload_path)
    mesh = create_mesh(dp=dist.get_world_size(), device_type="cpu")
    q, k, v = (torch.as_tensor(x) for x in p["qkv"])
    results = {"attention": {}}
    for case, kw in p["cases"].items():
        kw = {key: torch.as_tensor(val) if key == "kv_lengths" else val for key, val in kw.items()}
        results["attention"][case] = ring_self_attention(q, k, v, mesh, axis="dp", **kw)
    model = _tiny_model({}, p["state_dict"])
    last, cache = ring_prefill(model, torch.as_tensor(p["embeds"]), torch.as_tensor(p["positions"]), mesh, "dp",
                               cache_len=p["cache_len"])
    results["prefill"] = dict(last=last, k=cache.k, v=cache.v, length=cache.length, valid=cache.valid)
    os.environ["HICOM_RING_PREFILL_MIN"] = "1"
    hc = HICom(config=model.hicom_config, model=model, eos_token_id=2, cache_len=64)
    calls = []
    real = HICom._generate_ring
    HICom._generate_ring = lambda self, *a: calls.append(1) or real(self, *a)
    try:
        results["ids"] = hc.generate(p["ids"], frames=p["frames"], modal="video", max_new_tokens=6)
    finally:
        HICom._generate_ring = real
    results["ring_calls"] = len(calls)
    _save_rank(results, out_path, rank)


def pipeline_worker(rank: int, payload_path: str, out_path: str) -> None:
    """``pipeline_prefill`` of a 4-layer decoder over a ("pp",) mesh of the
    world (2 microbatches), its hidden states and the gradients of
    sum(hidden^2) of this stage's layers."""
    import dataclasses

    from hicom_tpu_torch.config import tiny_test_config
    from hicom_tpu_torch.models.qwen2 import Qwen2ForCausalLM
    from hicom_tpu_torch.parallel import create_pp_mesh, pipeline_prefill

    p = load(payload_path)
    lm = Qwen2ForCausalLM(dataclasses.replace(tiny_test_config().text_config, num_hidden_layers=4))
    missing, unexpected = lm.load_state_dict(p["state_dict"], strict=False)
    # JAX's init over embeddings makes no embedding table
    assert missing == ["model.embed_tokens.weight"] and not unexpected, (missing, unexpected)
    mesh = create_pp_mesh(device_type="cpu")
    hidden = pipeline_prefill(lm, torch.as_tensor(p["embeds"]), torch.as_tensor(p["positions"]), mesh,
                              num_microbatches=2)
    hidden.square().sum().backward()
    grads = {n: prm.grad for n, prm in lm.named_parameters() if prm.grad is not None and prm.grad.abs().sum() > 0}
    _save_rank({"hidden": hidden.detach(), "grads": grads}, out_path, rank)


def seq_api_worker(rank: int, ckpt: str, payload_path: str, out_path: str) -> None:
    """``mm_infer`` on each video of the payload under each
    ``HICOM_SEQ_PARALLEL`` setting, counting ``HICom.encode_long_video`` calls."""
    from transformers import AutoTokenizer

    import hicom_tpu_torch
    from hicom_tpu_torch.api import HICom

    p = load(payload_path)
    hc = hicom_tpu_torch.load_model(ckpt, dtype="float32", cache_len=256, device="cpu")
    tok = AutoTokenizer.from_pretrained(ckpt)
    calls = []
    real = HICom.encode_long_video
    HICom.encode_long_video = lambda self, *a, **k: calls.append(1) or real(self, *a, **k)
    results = {}
    try:
        for name, (video, setting) in p["cases"].items():
            os.environ["HICOM_SEQ_PARALLEL"] = setting
            before = len(calls)
            text = hicom_tpu_torch.mm_infer(video, p["question"], hc, tok, modal="video", guide_ids=p["guide_ids"],
                                            max_new_tokens=8)
            results[name] = (text, len(calls) - before)
    finally:
        HICom.encode_long_video = real
    _save_rank(results, out_path, rank)


# ---------------------------------------------------------------------------
# Tensor-parallel serving and data-parallel eval (multi-GPU slice C)
# ---------------------------------------------------------------------------


def _serve(model, reqs, mesh=None, **kw):
    """Token streams of ``ServeEngine(model, mesh=mesh, **kw)`` over ``reqs``
    (dicts of ``GenRequest`` fields), and the engine."""
    from hicom_tpu_torch.serve import GenRequest, ServeEngine

    eng = ServeEngine(model, device="cpu", mesh=mesh, **kw)
    ids = [eng.submit(GenRequest(**r)) for r in reqs]
    res = eng.run()
    return [res[i].tokens.tolist() for i in ids], eng


def mesh_serve_worker(rank: int, payload_path: str, out_path: str) -> None:
    """The payload's engine cases ({name: (mesh shape, engine kwargs)}) over
    its requests on the tiny model, each engine built with ``mesh=``; then
    the model's tensors against the payload's and an unsharded engine's
    streams. Per case: the streams, the cache's kv heads, the spec rounds,
    which blocks the replica split, and the tp collectives issued."""
    from hicom_tpu_torch.parallel.mesh import create_mesh
    from hicom_tpu_torch.parallel.sharding import ColumnShard, RowShard, all_gather_tp, all_reduce_tp

    p = load(payload_path)
    model = _tiny_model({}, p["state_dict"])
    results = {}
    for name, (shape, kw) in p["cases"].items():
        issued = all_reduce_tp.launches + all_gather_tp.launches
        streams, eng = _serve(model, p["requests"], create_mesh(*shape, device_type="cpu"), **kw)
        layer = eng.model.model.layers[0]
        tower = eng.model.model.vision_tower.vision_tower.vision_model.encoder.layers[0]
        split = {"attention": isinstance(layer.self_attn.o_proj, RowShard),
                 "mlp": isinstance(layer.mlp.down_proj, RowShard),
                 "tower": isinstance(tower.self_attn.out_proj, RowShard),
                 "lm_head": isinstance(eng.model.lm_head, ColumnShard)}
        results[name] = dict(streams=streams, kv_heads=eng.cache.k.shape[2], spec_rounds=eng.spec_rounds, split=split,
                             collectives=all_reduce_tp.launches + all_gather_tp.launches - issued)
    sd = model.state_dict()
    results["unchanged"] = all(torch.equal(sd[k], v) for k, v in p["state_dict"].items())
    results["unsharded"] = _serve(model, p["requests"], **p["unsharded"])[0]
    _save_rank(results, out_path, rank)


def eval_dp_worker(rank: int, ckpt: str, payload_path: str, out_path: str) -> None:
    """``mm_infer_batch`` after ``HICom.shard_for_eval()`` for each case of
    the payload ({name: (videos, kwargs)}), with the rows each ``generate``
    call ran; ``open_answer_file`` of a path of this rank's; the runner's
    exit on a ``--batch-size`` that does not divide the world."""
    from transformers import AutoTokenizer

    import hicom_tpu_torch
    from hicom_tpu_torch import api
    from hicom_tpu_torch.eval import runner
    from hicom_tpu_torch.eval.common import open_answer_file

    p = load(payload_path)
    hc = hicom_tpu_torch.load_model(ckpt, dtype="float32", cache_len=256, device="cpu")
    tok = AutoTokenizer.from_pretrained(ckpt)
    hc.shard_for_eval()
    rows = []
    real = api.generate_tokens
    api.generate_tokens = lambda m, ids, *a, **k: rows.append(ids.shape[0]) or real(m, ids, *a, **k)
    results = {}
    try:
        for name, (videos, kw) in p["cases"].items():
            before = len(rows)
            texts = api.mm_infer_batch(list(videos), [p["question"]] * len(videos), hc, tok,
                                       guide_ids=np.repeat(p["guide_ids"], len(videos), 0), **kw)
            results[name] = (texts, rows[before:])
    finally:
        api.generate_tokens = real
    with open_answer_file(os.path.join(p["answer_dir"], f"rank{rank}", "preds.json")) as f:
        f.write("answers\n")
    try:
        runner.main(["--benchmark", "mvbench", "--model-path", ckpt, "--question-file", "q", "--answer-file",
                     os.path.join(p["answer_dir"], "never.json"), "--data-parallel", "--batch-size", "3",
                     "--device", "cpu"])
        results["indivisible"] = None
    except SystemExit as e:
        results["indivisible"] = str(e)
    _save_rank(results, out_path, rank)
