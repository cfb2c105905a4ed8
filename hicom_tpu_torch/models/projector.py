"""HICom compression projector: guide injection + local/global compressors.

Port of ``hicom_tpu/models/projector.py``. The JAX modules are written per
sample and ``nn.vmap``-ed over the batch; here every module takes a leading
batch axis instead: volumes are (b, t, h, w, d), guides (b, d) or (b, Lg, d).
State-dict names follow the reference (``local_compressor.readout.0.weight``).

The local compressor runs ``fused_tile_attention`` (the K4 tile kernel on the
card, its plain version on the CPU; the batch folds into the frame axis,
which tiles the same way) wherever ``takes_tile_kernel`` holds and grad
mode is off; the overlapping grid, and every pass under grad mode (the
train step, as the JAX train step runs it), stays on ``tile_thw`` +
``sdpa`` (K4 has no backward). The global compressor's 32-query
cross-attention reaches the K2 flash kernel, and its K5/K6 backward,
through ``sdpa``. An anyres image reaches the projector as the merge's
base and patch grid. ``MeanPoolProjector`` is the ``mlp2x_gelu`` /
``linear`` baseline.

:meth:`HIComProjector.compress_shard` compresses one rank's chunk of a long
video's frames (``parallel/long_video.py``): the local compressor is exact on
the chunk when its length is a multiple of the temporal kernel, and the
global compressor's keys are split across the ranks (``sdpa(...,
kv_group=)``), with the 3D position embedding of the whole video sliced at
the chunk's first frame.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..config import GlobalCompressorSpec, HIComConfig, LocalCompressorSpec
from ..ops.attention import sdpa
from ..ops.grouping import tile_thw
from ..ops.local_attn import fused_tile_attention, takes_tile_kernel
from ..ops.pos_embed import sincos_pos_embed_3d
from ..ops.resize import resize_thw
from .layers import MultiheadAttention, TorchMLP, l2_normalize

Tensor = torch.Tensor


def _resolve_use_guide(config_use_guide, force_use_guide) -> Optional[str]:
    """A compressor-level ``guide<mode>`` DSL suffix overrides the model-level ``use_guide``."""
    mode = config_use_guide if force_use_guide is False else force_use_guide
    return None if mode in (None, "off") else mode


def _adapt_params(owner: nn.Module, name: str, proj: nn.Module, width: int, dtype) -> None:
    """Parameters of ``(1 - alpha) * x + alpha * norm(proj(x))``: ``<name>_proj``,
    ``<name>_norm`` and the learned scalar ``<name>_alpha``, on the owner."""
    setattr(owner, f"{name}_proj", proj)
    setattr(owner, f"{name}_norm", nn.LayerNorm(width, eps=1e-6, dtype=dtype))
    setattr(owner, f"{name}_alpha", nn.Parameter(torch.zeros(1, dtype=dtype)))


def _adapt_mix(owner: nn.Module, name: str, x: Tensor) -> Tensor:
    proj = getattr(owner, f"{name}_norm")(getattr(owner, f"{name}_proj")(x))
    alpha = getattr(owner, f"{name}_alpha").to(x.dtype)
    return (1 - alpha) * x + alpha * proj


class GuideInjector(nn.Module):
    """Inject the instruction embedding into compressor queries.

    * ``direct``: the query becomes the (projected) guide embedding;
    * ``coarse``: FiLM, ``norm(visual * (1 + scale) + shift)``;
    * ``fine``: per-token cross-attention visual <- guide, residual + norm.
    """

    def __init__(self, mode: str, text_dim: int, qk_dim: int, adapt_guide: bool = False,
                 mlp_depth: int = 2, dtype=None):
        super().__init__()
        if mode not in ("direct", "coarse", "fine"):
            raise NotImplementedError(f"guide mode {mode!r}")
        self.mode = mode
        self.adapt_guide = adapt_guide
        if text_dim != qk_dim:
            self.text2qk_proj = TorchMLP(text_dim, qk_dim, mlp_depth, dtype=dtype)
        if adapt_guide:
            _adapt_params(self, "guide", TorchMLP(qk_dim, qk_dim, mlp_depth, dtype=dtype), qk_dim, dtype)
        if mode == "coarse":
            self.coarse_proj = TorchMLP(qk_dim, qk_dim * 2, mlp_depth, dtype=dtype)
            self.coarse_norm = nn.LayerNorm(qk_dim, eps=1e-6, dtype=dtype)
        if mode == "fine":
            self.fine_proj = MultiheadAttention(qk_dim, max(1, qk_dim // 128), dtype=dtype)
            self.fine_norm = nn.LayerNorm(qk_dim, eps=1e-6, dtype=dtype)

    def _project_guide(self, guide: Tensor) -> Tensor:
        if hasattr(self, "text2qk_proj"):
            guide = self.text2qk_proj(guide)
        if self.adapt_guide:
            guide = _adapt_mix(self, "guide", guide)
        return guide

    def forward(self, visual: Tensor, guide: Tensor) -> Tensor:
        """visual (b, t, h, w, d) or (b, n, d); guide (b, d), or (b, Lg, d) for ``fine``."""
        b, d_vis = visual.shape[0], visual.shape[-1]
        if self.mode == "fine":
            orig = visual.shape
            query = visual.reshape(b, -1, 1, d_vis) if visual.ndim == 5 else visual[:, None]
            guide_b = guide[:, None].expand(b, query.shape[1], *guide.shape[1:])
            guide_b = self._project_guide(guide_b)
            attn = self.fine_proj(query, guide_b, guide_b)
            return self.fine_norm(query + attn).reshape(orig)
        guide = guide.reshape((b,) + (1,) * (visual.ndim - 2) + (guide.shape[-1],))
        guide = self._project_guide(guide.expand(*visual.shape[:-1], guide.shape[-1]))
        if self.mode == "direct":
            return guide
        scale, shift = self.coarse_proj(guide).chunk(2, dim=-1)
        return self.coarse_norm(visual * (1 + scale) + shift)


class LocalCompressor(nn.Module):
    """Grouped local cross-attention: one trilinear-downsampled query per
    T x S x S tile attends over its tile (keys: contrastive embeddings or raw
    features; values: raw features), then an MLP readout to the LLM width."""

    def __init__(self, spec: LocalCompressorSpec, qk_dim: int, encoder_hidden_size: int,
                 output_hidden_size: int, use_guide: Optional[str], mlp_depth: int = 2, dtype=None):
        super().__init__()
        self.spec = spec
        self.qk_dim = qk_dim
        self.use_guide = use_guide
        if spec.adapt_k:
            _adapt_params(self, "k", TorchMLP(qk_dim, qk_dim, mlp_depth, dtype=dtype), qk_dim, dtype)
        if spec.adapt_v:
            _adapt_params(self, "v", TorchMLP(encoder_hidden_size, encoder_hidden_size, mlp_depth, dtype=dtype),
                          encoder_hidden_size, dtype)
        self.adapt_q = spec.adapt_q and use_guide != "direct"  # direct replaces q entirely
        if self.adapt_q:
            _adapt_params(self, "q", nn.Linear(encoder_hidden_size, qk_dim, bias=False, dtype=dtype), qk_dim, dtype)
        if use_guide is not None:
            self.guide_injector = GuideInjector(use_guide, qk_dim, qk_dim, spec.adapt_guide, mlp_depth, dtype=dtype)
        self.readout = TorchMLP(encoder_hidden_size, output_hidden_size, mlp_depth, dtype=dtype)

    def forward(self, frames_feature: Tensor, frames_embed: Optional[Tensor] = None,
                guide_embed: Optional[Tensor] = None, modal: str = "video",
                logit_scale: Optional[Tensor] = None, logit_bias: Union[float, Tensor] = 0.0) -> Tensor:
        """frames_feature (b, t, h, w, dv) -> (b, t1, h1, w1, D)."""
        b, t, h, w, _ = frames_feature.shape
        spec = self.spec
        if frames_embed is not None and logit_scale is not None:
            frames_embed = l2_normalize(frames_embed)
            guide_embed = l2_normalize(guide_embed) if guide_embed is not None else None
        key = frames_feature if frames_embed is None else frames_embed
        if spec.adapt_k:
            key = _adapt_mix(self, "k", key)
        value = _adapt_mix(self, "v", frames_feature) if spec.adapt_v else frames_feature

        kt = 1 if (modal == "image" or t == 1) else spec.temporal_kernel_size
        ks = spec.spatial_kernel_size
        down = (math.ceil(t / kt), math.ceil(h / ks), math.ceil(w / ks))
        q = resize_thw(frames_feature, down)
        if self.adapt_q:
            q = _adapt_mix(self, "q", q)
        if self.use_guide is not None:
            q = self.guide_injector(q, guide_embed)

        att_scale = torch.exp(logit_scale) if logit_scale is not None else 1.0 / math.sqrt(self.qk_dim)
        dv = value.shape[-1]
        if takes_tile_kernel((t, h, w), key.shape[-1], dv, (kt, ks, ks), key.dtype) and not torch.is_grad_enabled():
            # tiles never cross frames, so the batch folds into the frame axis
            out = fused_tile_attention(q.reshape(b * down[0], *down[1:], q.shape[-1]),
                                       key.reshape(b * t, h, w, key.shape[-1]),
                                       value.reshape(b * t, h, w, dv), (kt, ks, ks), att_scale, logit_bias)
            out = out.reshape(b, *down, dv)
        else:
            rk = tile_thw(key, (kt, ks, ks))  # (b, G, K, qk)
            rv = tile_thw(value, (kt, ks, ks))
            rq = q.reshape(b, -1, 1, q.shape[-1])  # (b, G, 1, qk)
            out = sdpa(rq, rk, rv, scale=att_scale, logit_bias=logit_bias).reshape(b, *down, dv)
        return self.readout(out)


class GlobalCompressor(nn.Module):
    """N learned (zero-init) queries, guide-injected, attend over all t*h*w
    tokens with a 3D sinusoidal position embedding; residual + MLP readout."""

    def __init__(self, spec: GlobalCompressorSpec, text_dim: int, embed_dim: int, output_hidden_size: int,
                 use_guide: Optional[str], mlp_depth: int = 2, dtype=None):
        super().__init__()
        self.spec = spec
        self.embed_dim = embed_dim
        self.use_guide = use_guide
        self.query = nn.Parameter(torch.zeros(spec.num_queries, embed_dim, dtype=dtype))
        if use_guide is not None:
            self.guide_injector = GuideInjector(use_guide, text_dim, embed_dim, spec.adapt_guide, mlp_depth,
                                                dtype=dtype)
        self.attn_layer = MultiheadAttention(embed_dim, max(1, embed_dim // 128), dtype=dtype)
        self.readout = TorchMLP(embed_dim, output_hidden_size, mlp_depth, dtype=dtype)

    def forward(self, frames_feature: Tensor, frames_embed: Optional[Tensor] = None,
                guide_embed: Optional[Tensor] = None, modal: str = "video",
                logit_scale: Optional[Tensor] = None, logit_bias: Union[float, Tensor] = 0.0,
                t_offset: int = 0, t_total: Optional[int] = None, kv_group=None) -> Tensor:
        """frames_feature (b, t, h, w, d) -> (b, N, D). Split across ranks:
        the chunk holds frames [t_offset, t_offset + t) of ``t_total``, and
        ``kv_group`` is the group whose ranks hold the other chunks."""
        b, t, h, w, d = frames_feature.shape
        if self.spec.use_pos_emb:
            pos = sincos_pos_embed_3d(t_total or t, h, w, self.embed_dim, frames_feature.device)
            frames_feature = frames_feature + pos[t_offset:t_offset + t].to(frames_feature.dtype)
        query = self.query.to(frames_feature.dtype)[None].expand(b, -1, -1)
        if self.use_guide is not None:
            query = self.guide_injector(query, guide_embed)
        kv = frames_feature.reshape(b, t * h * w, d)
        x = self.attn_layer(query, kv, kv, logit_scale=logit_scale, logit_bias=logit_bias, kv_group=kv_group)
        return self.readout(query + x)


class HIComProjector(nn.Module):
    """Runs the local and/or global compressor and concatenates
    ``[local_tokens ; global_tokens]``; ``use_clip_scale`` adds the SigLIP
    contrastive logit_scale/logit_bias parameters."""

    def __init__(self, config: HIComConfig, dtype=None):
        super().__init__()
        self.config = config
        spec = config.projector
        if spec.kind != "hicom":
            raise ValueError(f"{config.mm_projector_type!r} is a mean-pool projector (MeanPoolProjector)")
        use_cs = [s for s in config.use_clip_scale.split(",") if s]
        self.local_use_clip_scale = "local" in use_cs
        self.global_use_clip_scale = "global" in use_cs
        for side in ("local", "global"):
            if side in use_cs:
                setattr(self, f"{side}_logit_scale", nn.Parameter(torch.zeros((), dtype=dtype)))
                setattr(self, f"{side}_logit_bias", nn.Parameter(torch.zeros((), dtype=dtype)))
        self.local_compressor = None
        self.global_compressor = None
        if spec.local is not None:
            self.local_compressor = LocalCompressor(
                spec.local, config.qk_dim, config.mm_hidden_size, config.hidden_size,
                _resolve_use_guide(config.use_guide, spec.local.force_use_guide), dtype=dtype)
        if spec.global_ is not None:
            self.global_compressor = GlobalCompressor(
                spec.global_, config.qk_dim, config.mm_hidden_size, config.hidden_size,
                _resolve_use_guide(config.use_guide, spec.global_.force_use_guide), dtype=dtype)

    def forward(self, frames_feature: Union[Tensor, dict], frames_embed: Optional[Union[Tensor, dict]] = None,
                guide_embed: Optional[Tensor] = None, modal: str = "video",
                image_newline: Optional[Tensor] = None) -> Tensor:
        """(b, t, h, w, d) volumes -> (b, V, D) visual tokens. An anyres image
        comes as the merge's dict (``models/anyres.apply_anyres_plan``):
        ``base`` (b, hw, hw, d) or None and ``patch`` (b, h, w, d), each a
        one-frame volume; the local compressor takes both (the patch rows with
        a newline column each) and the global compressor the patch grid."""
        from .postprocess import post_process_visual_feature

        def volume(x, part):  # one anyres part as a (b, 1, h, w, d) volume
            return None if x is None else x[part][:, None]

        is_dict = isinstance(frames_feature, dict)
        parts = []
        if self.local_compressor is not None:
            ls = self.local_logit_scale if self.local_use_clip_scale else None
            lb = self.local_logit_bias if self.local_use_clip_scale else 0.0
            if is_dict:
                for part, anyres in (("base", False), ("patch", True)):
                    if frames_feature[part] is None:
                        continue
                    local = self.local_compressor(volume(frames_feature, part), volume(frames_embed, part),
                                                  guide_embed, modal, ls, lb)
                    parts.append(post_process_visual_feature(self.config, local, modal, image_newline, anyres))
            else:
                local = self.local_compressor(frames_feature, frames_embed, guide_embed, modal, ls, lb)
                parts.append(post_process_visual_feature(self.config, local, modal, image_newline, is_anyres=False))
        if self.global_compressor is not None:
            gs = self.global_logit_scale if self.global_use_clip_scale else None
            gb = self.global_logit_bias if self.global_use_clip_scale else 0.0
            if is_dict:
                frames_feature, frames_embed = volume(frames_feature, "patch"), volume(frames_embed, "patch")
            parts.append(self.global_compressor(frames_feature, frames_embed, guide_embed, modal, gs, gb))
        return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]

    def compress_shard(self, frames_feature: Tensor, frames_embed: Optional[Tensor], guide_embed: Optional[Tensor],
                       modal: str, t_offset: int, t_total: int, kv_group):
        """One rank's chunk (b, t_loc, h, w, d) of a ``t_total``-frame video,
        its first frame at ``t_offset``: returns ``(local_raw, global_tokens)``,
        the local compressor's (b, t', h', w', D) grid before post-processing
        (the caller gathers the chunks and post-processes the whole grid once)
        and the global compressor's (b, N, D) tokens, equal on every rank of
        ``kv_group``; either is None without its compressor."""
        t_loc = frames_feature.shape[1]
        local_raw = global_tokens = None
        if self.local_compressor is not None:
            kt = self.local_compressor.spec.temporal_kernel_size
            if modal != "video" or t_loc % kt or t_loc < kt:
                raise ValueError(f"sharded local compression needs video chunks divisible by the temporal kernel "
                                 f"(t_loc={t_loc}, kernel={kt})")
            ls = self.local_logit_scale if self.local_use_clip_scale else None
            lb = self.local_logit_bias if self.local_use_clip_scale else 0.0
            local_raw = self.local_compressor(frames_feature, frames_embed, guide_embed, modal, ls, lb)
        if self.global_compressor is not None:
            gs = self.global_logit_scale if self.global_use_clip_scale else None
            gb = self.global_logit_bias if self.global_use_clip_scale else 0.0
            global_tokens = self.global_compressor(frames_feature, frames_embed, guide_embed, modal, gs, gb,
                                                   t_offset=t_offset, t_total=t_total, kv_group=kv_group)
        return local_raw, global_tokens


class MeanPoolProjector(nn.Module):
    """The ``mlp<N>x_gelu`` / ``linear`` baseline: an MLP per token under
    ``layers`` (the JAX package's name; the reference's ``mm_projector.bin``
    keys ``0.weight`` / ``2.weight`` move there at load). The model applies
    the 2x2 spatial downsample of video (``HIComModel._mean_pool_project``)."""

    def __init__(self, in_dim: int, out_dim: int, depth: int = 2, dtype=None):
        super().__init__()
        self.layers = TorchMLP(in_dim, out_dim, depth, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)
