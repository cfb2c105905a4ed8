"""Quantized linears of the serving configurations, their converters and calibration.

Port of ``hicom_tpu/models/quant.py`` and of the quantized linears of
``hicom_tpu/models/qwen2.py``, in the ``nn.Linear`` orientation: weight codes
are (out, in), so ``weight_q`` is the JAX ``kernel_q`` transposed. Modes:

* decoder: ``int8`` (weight-only, :class:`QuantLinear`), ``nf4`` (weight-only,
  :class:`QuantLinear4`), ``w8a8`` / ``w8a8_mlp`` (int8 activations x int8
  weights, dynamic per-row activation scales, :class:`W8A8Linear`) and
  ``w8a8s`` / ``w8a8s_mlp`` (static calibrated per-tensor scales with
  SmoothQuant factors, :class:`W8A8LinearS`); ``*_mlp`` keeps attention float;
* SigLIP tower: ``w8a8`` (every encoder linear and the head MLP),
  ``w8a8_mlp`` (fc1/fc2), ``w8a8_mlp_qkv`` (fc1/fc2 and q/k/v over one shared
  activation quantization, :class:`W8A8LinearQ`) and their ``w8a8s*`` twins.

The int8 products accumulate in int32 (:func:`int8_matmul`): ``torch._int_mm``
on the card (no TPU kernel stands behind them: JAX runs XLA int8 dots), an
exact float64 product of the codes on the CPU (|acc| <= K * 127^2 < 2^53).

Calibration is a mode of the same modules: with ``calibrate`` set, a static
site quantizes with the live per-tensor absmax and records the per-tensor and
per-channel absmax, max-reduced over calls, in ``act_amax`` / ``act_amax_ch``
(JAX sows them into a 'calib' collection). :func:`fill_act_scales` turns what
was recorded into ``act_scale`` and, for heavy-tailed channel profiles,
SmoothQuant ``act_smooth`` factors with the weights refitted.

State dicts name the parts ``<linear>.weight_q`` (int8, (out, in)),
``.weight_nf4`` (uint8, (out, in/2), two codes a byte, low nibble first),
``.weight_scale`` (fp32, (out,), or (out, in/64) for NF4), ``.act_scale``
(fp32 scalar), ``.act_smooth`` (fp32, (in,)) and ``<attn>.qkv_quant.*``.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor

DECODER_MODES = ("int8", "nf4", "w8a8", "w8a8_mlp", "w8a8s", "w8a8s_mlp")
TOWER_MODES = ("w8a8", "w8a8_mlp", "w8a8_mlp_qkv", "w8a8s", "w8a8s_mlp", "w8a8s_mlp_qkv")

# bitsandbytes' NF4 codebook: the 16 quantiles of a standard normal scaled to
# [-1, 1] (QLoRA, Dettmers et al. 2023); the JAX package's NF4_CODEBOOK
NF4_CODEBOOK = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
], np.float32)
NF4_GROUP = 64  # rows of one scale (bnb's blocksize)
# _int_mm on the card takes more than 16 rows
INT_MM_MIN_ROWS = 17


# --------------------------------------------------------------------------- #
# Modes and the quantizers
# --------------------------------------------------------------------------- #


def parse_tower_quant(mode: Optional[str]) -> Tuple[Optional[str], bool, bool]:
    """'w8a8s_mlp_qkv+calib' -> (base 'w8a8s_mlp_qkv', static True, calib True)."""
    if not mode:
        return None, False, False
    calib = mode.endswith("+calib")
    base = mode[: -len("+calib")] if calib else mode
    return base, base.startswith("w8a8s"), calib


def quant_covers(base: Optional[str], site: str) -> bool:
    """Whether tower mode ``base`` covers ``site`` in {mlp, qkv, out}."""
    norm = base.replace("w8a8s", "w8a8") if base else None
    return {
        "mlp": norm in ("w8a8", "w8a8_mlp", "w8a8_mlp_qkv"),
        "qkv": norm in ("w8a8", "w8a8_mlp_qkv"),
        "out": norm == "w8a8",
    }[site]


def check_modes(text_mode, vision_mode) -> None:
    """Raise on a quantization the port does not run (a typo, a calibration
    suffix from outside the calibration call, a quantized CLIP tower)."""
    if text_mode is not None and text_mode not in DECODER_MODES:
        raise ValueError(f"decoder quantization {text_mode!r} is not one of {DECODER_MODES}")
    if vision_mode is not None and vision_mode not in TOWER_MODES:
        raise ValueError(f"tower quantization {vision_mode!r} is not one of {TOWER_MODES}")


def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(..., d) -> int8 codes + per-row scale (..., 1) fp32."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def quantize_static(x: Tensor, s: Tensor) -> Tensor:
    """int8 codes from a calibrated scale ``s`` (a scalar, or per input
    channel with SmoothQuant factors folded in): x * (1 / max(s, 1e-20))."""
    inv = (1.0 / s.float().clamp_min(1e-20)).float()
    return torch.round(x.float() * inv).clamp(-127, 127).to(torch.int8)


def quantize_int8_weight(w: Tensor) -> Tuple[Tensor, Tensor]:
    """(out, in) float -> int8 codes (out, in) and per-output-row scales (out,)
    fp32, the JAX converters' per-column absmax in the (in, out) layout."""
    k = w.float()
    scale = k.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    return torch.round(k / scale[:, None]).clamp(-127, 127).to(torch.int8), scale


def quantize_nf4_weight(w: Tensor) -> Tuple[Tensor, Tensor]:
    """(out, in) float -> packed NF4 codes (out, in/2) uint8 (even input
    channel in the low nibble) and per-(row, 64-channel group) absmax scales
    (out, ceil(in/64)) fp32. The nearest codebook entry is found against the
    midpoints between entries (a sorted codebook), as the JAX converter does."""
    out_dim, in_dim = w.shape
    if in_dim % 2:
        raise ValueError("NF4 packs two input channels a byte: in_features must be even")
    pad = (-in_dim) % NF4_GROUP
    k = torch.nn.functional.pad(w.float(), (0, pad))
    g = k.reshape(out_dim, -1, NF4_GROUP)
    absmax = g.abs().amax(dim=2).clamp_min(1e-8)  # (out, groups)
    norm = (g / absmax[:, :, None]).reshape(out_dim, -1)[:, :in_dim]
    book = _codebook(w.device, torch.float32)
    mids = (book[1:] + book[:-1]) / 2
    codes = torch.searchsorted(mids, norm.contiguous()).to(torch.uint8)
    packed = codes[:, 0::2] | (codes[:, 1::2] << 4)
    return packed.contiguous(), absmax


@functools.lru_cache(maxsize=None)
def _codebook(device: torch.device, dtype: torch.dtype) -> Tensor:
    """The NF4 codebook on ``device`` in ``dtype``, uploaded once."""
    return torch.from_numpy(NF4_CODEBOOK).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _byte_pairs(device: torch.device, dtype: torch.dtype) -> Tensor:
    """(256, 2): the codebook values of a packed byte's low and high nibble."""
    b = torch.arange(256)
    return _codebook(device, dtype)[torch.stack([b & 0xF, b >> 4], dim=1).to(device)]


def nf4_dequant(packed: Tensor, scale: Tensor, dtype) -> Tensor:
    """(out, in/2) packed codes and (out, groups) scales -> (out, in) weight in
    ``dtype``: codebook values and scales cast to ``dtype`` before the
    product, as the JAX ``QuantDense4`` computes it. One gather of both
    nibbles' values per byte (int32 indices)."""
    out_dim, half = packed.shape
    w = _byte_pairs(packed.device, dtype).index_select(0, packed.reshape(-1).int()).reshape(out_dim, 2 * half)
    s = scale.to(dtype)
    if (2 * half) % NF4_GROUP == 0:
        return (w.reshape(out_dim, -1, NF4_GROUP) * s[:, :, None]).reshape(out_dim, 2 * half)
    return w * s.repeat_interleave(NF4_GROUP, dim=1)[:, : 2 * half]


def int8_matmul(xq: Tensor, wq: Tensor) -> Tensor:
    """(..., K) int8 activation codes x (N, K) int8 weight codes -> (..., N)
    int32, exact. On the card ``torch._int_mm`` (rows above 16, K and N
    multiples of 8; fewer rows are padded with zero codes, which touch no real
    row; the (N, K) weight is the column-major (K, N) operand it takes without
    a copy); on the CPU a float64 product of the codes, exact."""
    lead = xq.shape[:-1]
    a = xq.reshape(-1, xq.shape[-1])
    if a.is_cuda:
        m = a.shape[0]
        if m < INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - m, a.shape[1])])
        acc = torch._int_mm(a, wq.t())[:m]
    else:
        acc = (a.double() @ wq.double().t()).to(torch.int32)
    return acc.reshape(*lead, wq.shape[0])


# --------------------------------------------------------------------------- #
# Linears
# --------------------------------------------------------------------------- #


class _DequantMatmul(torch.autograd.Function):
    """``x @ dequant(*codes)^T`` that keeps the codes, not the dequantized
    weight, for the backward: ``dx`` dequantizes again. Under QLoRA the
    base weights take no gradient, so a step holds no float copy of them."""

    @staticmethod
    def forward(ctx, x, dequant, *codes):
        ctx.dequant = dequant
        ctx.save_for_backward(*codes)
        return x @ dequant(*codes).t()

    @staticmethod
    def backward(ctx, gy):
        codes = ctx.saved_tensors  # unpacked once (remat's recompute hooks allow no more)
        gx = gy @ ctx.dequant(*codes) if ctx.needs_input_grad[0] else None
        return (gx, None) + (None,) * len(codes)


def _int8_weight(wq: Tensor, dtype) -> Tensor:
    return wq.to(dtype)


class _QuantBase(nn.Module):
    """Shared parts: shapes, the compute dtype, the optional float bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype if dtype is not None else torch.get_default_dtype()
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype)) if bias else None

    def _add_bias(self, y: Tensor) -> Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def set_weight(self, w: Tensor) -> None:
        """Quantize a float (out, in) weight into this module's codes, on their device."""
        raise NotImplementedError


class QuantLinear(_QuantBase):
    """Weight-only int8 linear (JAX ``QuantDense``): int8 codes and per-output
    scales at rest; ``(x @ codes^T)`` rounded to the compute dtype, times the
    scale cast to that dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False, dtype=None):
        super().__init__(in_features, out_features, bias, dtype)
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))

    def set_weight(self, w: Tensor) -> None:
        self.weight_q, self.weight_scale = quantize_int8_weight(w.to(self.weight_q.device))

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        y = _DequantMatmul.apply(x.to(dt), functools.partial(_int8_weight, dtype=dt), self.weight_q)
        return self._add_bias(y * self.weight_scale.to(dt))


class QuantLinear4(_QuantBase):
    """Weight-only NF4 linear (JAX ``QuantDense4``): packed codebook indices and
    per-(row, 64-channel group) scales at rest, dequantized in the compute
    dtype for each product (and again in the backward)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False, dtype=None):
        super().__init__(in_features, out_features, bias, dtype)
        groups = -(-in_features // NF4_GROUP)
        self.register_buffer("weight_nf4", torch.zeros(out_features, in_features // 2, dtype=torch.uint8))
        self.register_buffer("weight_scale", torch.ones(out_features, groups, dtype=torch.float32))

    def set_weight(self, w: Tensor) -> None:
        self.weight_nf4, self.weight_scale = quantize_nf4_weight(w.to(self.weight_nf4.device))

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        y = _DequantMatmul.apply(x.to(dt), functools.partial(nf4_dequant, dtype=dt), self.weight_nf4,
                                 self.weight_scale)
        return self._add_bias(y)


class W8A8LinearQ(_QuantBase):
    """int8 x int8 linear over an already quantized input (JAX ``W8A8DenseQ``):
    q, k and v share one quantization of their layer-norm output.
    ``(acc * sx) * scale`` in fp32, then the compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias, dtype)
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32))

    def set_weight(self, w: Tensor) -> None:
        self.weight_q, self.weight_scale = quantize_int8_weight(w.to(self.weight_q.device))

    def forward_q(self, xq: Tensor, sx: Tensor) -> Tensor:
        acc = int8_matmul(xq, self.weight_q)
        return self._add_bias((acc.float() * sx * self.weight_scale).to(self.dtype))


class W8A8Linear(W8A8LinearQ):
    """int8-activation x int8-weight linear with int32 accumulation and
    dynamic per-row activation scales (JAX ``W8A8Dense``)."""

    def forward(self, x: Tensor) -> Tensor:
        return self.forward_q(*quantize_rows(x))


class _Calibrated:
    """The calibration mode of a static site: ``calibrate`` on, each call
    quantizes with its live per-tensor absmax and max-reduces the per-tensor
    and per-channel absmax into ``act_amax`` / ``act_amax_ch``."""

    calibrate = False
    act_amax: Optional[Tensor] = None
    act_amax_ch: Optional[Tensor] = None

    def reset_calibration(self) -> None:
        self.act_amax = self.act_amax_ch = None

    def _record(self, x: Tensor) -> Tensor:
        ax = x.float().abs()
        amax_ch = ax.reshape(-1, ax.shape[-1]).amax(dim=0)
        amax = amax_ch.max()
        if self.act_amax is None:
            self.act_amax, self.act_amax_ch = amax, amax_ch
        else:
            self.act_amax = torch.maximum(self.act_amax, amax)
            self.act_amax_ch = torch.maximum(self.act_amax_ch, amax_ch)
        return amax.clamp_min(1e-8) / 127.0


class ActQuant(_Calibrated, nn.Module):
    """Static per-tensor activation quantizer (JAX ``ActQuant``): returns
    (codes of ``x / (act_smooth * act_scale)``, ``act_scale``)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.register_buffer("act_scale", torch.ones((), dtype=torch.float32))
        self.register_buffer("act_smooth", torch.ones(in_features, dtype=torch.float32))

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        if self.calibrate:
            s = self._record(x)
            return quantize_static(x, s), s
        return quantize_static(x, self.act_smooth * self.act_scale), self.act_scale


class W8A8LinearS(_Calibrated, W8A8LinearQ):
    """Static-scale int8 x int8 linear (JAX ``W8A8DenseS``): a calibrated
    per-tensor activation scale and per-input-channel SmoothQuant factors
    beside the weight codes. ``acc * (sx * scale)`` in fp32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias, dtype)
        self.register_buffer("act_scale", torch.ones((), dtype=torch.float32))
        self.register_buffer("act_smooth", torch.ones(in_features, dtype=torch.float32))

    def forward(self, x: Tensor) -> Tensor:
        if self.calibrate:
            sx = self._record(x)
            xq = quantize_static(x, sx)
        else:
            sx = self.act_scale
            xq = quantize_static(x, self.act_smooth * self.act_scale)
        acc = int8_matmul(xq, self.weight_q)
        return self._add_bias((acc.float() * (sx * self.weight_scale)).to(self.dtype))


def make_linear(mode: Optional[str], in_features: int, out_features: int, bias: bool, dtype=None) -> nn.Module:
    """The decoder's linear for its layer mode (JAX ``make_dense``)."""
    if mode == "int8":
        return QuantLinear(in_features, out_features, bias, dtype)
    if mode == "nf4":
        return QuantLinear4(in_features, out_features, bias, dtype)
    if mode == "w8a8":
        return W8A8Linear(in_features, out_features, bias, dtype)
    if mode == "w8a8s":
        return W8A8LinearS(in_features, out_features, bias, dtype)
    if mode is None:
        return nn.Linear(in_features, out_features, bias=bias, dtype=dtype)
    raise ValueError(f"no linear for quantization {mode!r}")


def make_tower_linear(mode: Optional[str], in_features: int, out_features: int, dtype=None) -> nn.Module:
    """A tower MLP / out_proj linear (with bias) under ``w8a8`` / ``w8a8s`` / float."""
    if mode == "w8a8s":
        return W8A8LinearS(in_features, out_features, True, dtype)
    if mode == "w8a8":
        return W8A8Linear(in_features, out_features, True, dtype)
    return nn.Linear(in_features, out_features, dtype=dtype)


def decoder_layer_modes(mode: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """(attention, MLP) linear modes of a decoder layer: ``*_mlp`` keeps the
    attention projections float, static modes use ``w8a8s`` linears."""
    base, static, _ = parse_tower_quant(mode)
    if base in ("w8a8_mlp", "w8a8s_mlp"):
        return None, "w8a8s" if static else "w8a8"
    if static:
        return "w8a8s", "w8a8s"
    return base, base


# --------------------------------------------------------------------------- #
# Converters (state dicts under the port's names)
# --------------------------------------------------------------------------- #

QUANT_LINEARS = (QuantLinear, QuantLinear4, W8A8LinearQ)


def tower_quant_targets(mode: str) -> tuple:
    """Linear names a tower mode converts (q/k/v share one activation quantizer)."""
    base, static, _ = parse_tower_quant(mode)
    norm = base.replace("w8a8s", "w8a8") if static else base
    return {
        "w8a8_mlp": ("fc1", "fc2"),
        "w8a8_mlp_qkv": ("fc1", "fc2", "q_proj", "k_proj", "v_proj"),
    }.get(norm, ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"))


def decoder_quant_targets(mode: str) -> tuple:
    """Linear names ``quantize_decoder_params`` converts under ``mode``."""
    if mode in ("w8a8_mlp", "w8a8s_mlp"):
        return ("gate_proj", "up_proj", "down_proj")
    return ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


TOWER_PREFIX = "model.vision_tower.vision_tower."
_DECODER_LAYER = re.compile(r"^model\.layers\.\d+\.")


def tower_sites(names, mode: str):
    """The tower linears (module names) that ``mode`` converts, from the
    weight names of a state dict."""
    targets = tower_quant_targets(mode)
    return sorted(n[: -len(".weight")] for n in names if n.startswith(TOWER_PREFIX) and n.endswith(".weight")
                  and n[: -len(".weight")].rsplit(".", 1)[-1] in targets)


def decoder_sites(names, mode: str):
    """The decoder linears (module names) that ``mode`` converts."""
    targets = decoder_quant_targets(mode)
    return sorted(n[: -len(".weight")] for n in names if _DECODER_LAYER.match(n) and n.endswith(".weight")
                  and n[: -len(".weight")].rsplit(".", 1)[-1] in targets)


def _convert(sd: Mapping[str, Tensor], sites, mode: str, static: bool, device=None,
             shared: tuple = ()) -> Dict[str, Tensor]:
    """``sd`` with each site's float weight replaced by its codes; static
    modes give each site not in ``shared`` (sites fed by a shared quantizer)
    its own ``act_scale`` and ``act_smooth``."""
    out = dict(sd)
    for site in sites:
        w = out.pop(f"{site}.weight")
        w = w.to(device) if device is not None else w
        if mode == "nf4":
            out[f"{site}.weight_nf4"], out[f"{site}.weight_scale"] = quantize_nf4_weight(w)
        else:
            out[f"{site}.weight_q"], out[f"{site}.weight_scale"] = quantize_int8_weight(w)
            if static and site.rsplit(".", 1)[-1] not in shared:
                out[f"{site}.act_scale"] = torch.ones((), dtype=torch.float32, device=w.device)
                out[f"{site}.act_smooth"] = torch.ones(w.shape[1], dtype=torch.float32, device=w.device)
        del w
    return out


def quantize_tower_params(sd: Mapping[str, Tensor], mode: str = "w8a8", device=None) -> Dict[str, Tensor]:
    """Float tower weights -> the ``mode`` layout (JAX ``quantize_tower_params``):
    covered encoder and head-MLP linears become int8 codes with per-output
    scales; static modes add ``act_scale`` = 1 and ``act_smooth`` = 1 at each
    site that quantizes its own input, and one ``qkv_quant`` per attention
    whose q/k/v share theirs. Embeddings and norms stay float. ``device``:
    where the codes are made (default: each weight's)."""
    base, static, _ = parse_tower_quant(mode)
    sites = tower_sites(sd, mode)
    out = _convert(sd, sites, mode, static, device, shared=("q_proj", "k_proj", "v_proj"))
    if static and quant_covers(base, "qkv"):
        for site in sites:
            if site.endswith(".q_proj"):
                attn = site[: -len("q_proj")]
                dev = out[f"{site}.weight_q"].device
                out[f"{attn}qkv_quant.act_scale"] = torch.ones((), dtype=torch.float32, device=dev)
                out[f"{attn}qkv_quant.act_smooth"] = torch.ones(out[f"{site}.weight_q"].shape[1],
                                                                dtype=torch.float32, device=dev)
    return out


def quantize_decoder_params(sd: Mapping[str, Tensor], mode: str = "int8", device=None) -> Dict[str, Tensor]:
    """Float decoder weights -> the ``mode`` layout (JAX
    ``quantize_decoder_params``): ``int8`` / ``w8a8`` / ``w8a8_mlp`` int8
    codes with per-output scales, ``nf4`` packed codes with per-64-channel
    scales, ``w8a8s*`` int8 codes with ``act_scale`` and ``act_smooth``.
    Embeddings, norms and ``lm_head`` stay float."""
    return _convert(sd, decoder_sites(sd, mode), mode, mode.startswith("w8a8s"), device)


def prune_fp_kernels(sd: Mapping[str, Tensor], mode: str, targets=None) -> Dict[str, Tensor]:
    """fp16 host copies of the weights a static ``mode`` converts, by module
    name: the SmoothQuant refit of :func:`fill_act_scales` requantizes from
    them instead of from the int8 codes. Empty for dynamic modes. ``targets``
    (e.g. :func:`decoder_quant_targets`) selects decoder sites instead of the
    tower's."""
    base, static, _ = parse_tower_quant(mode)
    if not static:
        return {}
    sites = tower_sites(sd, mode) if targets is None else [
        s for s in decoder_sites(sd, "w8a8s") if s.rsplit(".", 1)[-1] in targets]
    return {s: sd[f"{s}.weight"].to("cpu", torch.float16) for s in sites}


def merge_calib(a: Mapping[str, Tensor], b: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """Elementwise max of two recorded calibrations (several batches)."""
    return {k: torch.maximum(a[k], b[k]) for k in a}


def _median(a: Tensor) -> Tensor:
    """The median of the last axis, the two middle values averaged for an even
    count (``jnp.median``; ``torch.median`` takes the lower one)."""
    return torch.quantile(a, 0.5, dim=-1, keepdim=True)


def _smoothed(amax_ch: Tensor, sites, floor: float, alpha: float, ratio: float):
    """(act_scale, act_smooth, [(codes, scales)]) of one calibrated site fed by
    ``sites`` = [(weight_q, weight_scale, fp weight or None)] (one for a
    ``W8A8LinearS``; q/k/v for a shared ``qkv_quant``)."""
    a = amax_ch.float().clamp_min(floor)
    hot = (a.max(dim=-1, keepdim=True).values / _median(a).clamp_min(floor)) > ratio  # (1,)

    def base_weight(q, s, fp):
        return fp.to(q.device).float() if fp is not None else q.float() * s.float()[:, None]

    w_amax = None
    for q, s, fp in sites:
        w = base_weight(q, s, fp).abs().amax(dim=0)  # per input channel
        w_amax = w if w_amax is None else torch.maximum(w_amax, w)
    c = a ** alpha / w_amax.clamp_min(floor) ** (1.0 - alpha)
    c = torch.where(hot, c.clamp(1e-4, 1e4), torch.ones_like(c))
    act_scale = (a / c).max() / 127.0
    refit = []
    for q, s, fp in sites:
        k = base_weight(q, s, fp) * c[None, :]
        absmax = k.abs().amax(dim=1).clamp_min(floor)
        q2 = torch.round(k / (absmax / 127.0)[:, None]).clamp(-127, 127).to(torch.int8)
        refit.append((torch.where(hot, q2, q), torch.where(hot, absmax / 127.0, s.float())))
    return act_scale, c, refit


def fill_act_scales(params: Mapping[str, Tensor], calib: Mapping[str, Tensor], floor: float = 1e-8,
                    smooth_alpha: float = 0.5, outlier_ratio: float = 8.0,
                    fp_params: Optional[Mapping[str, Tensor]] = None) -> Dict[str, Tensor]:
    """Write calibrated activation scales into a static-quant state dict (JAX
    ``fill_act_scales``). ``calib`` holds ``<site>.act_amax`` (and
    ``<site>.act_amax_ch``) as the calibration mode records them. At each
    site ``act_scale = max(a / c) / 127`` with ``a`` the per-channel absmax;
    where the channel profile is heavy-tailed (``max / median >
    outlier_ratio``) ``c = a^alpha / w_amax^(1 - alpha)`` (SmoothQuant, Xiao
    et al. 2022) becomes ``act_smooth`` and the weights are refitted from
    ``c * W``: from ``fp_params[site]`` (float (out, in) weights by module
    name, :func:`prune_fp_kernels`) when given, else from the int8 codes.
    Elsewhere ``c`` = 1 and the codes stay bit-identical. A site with only
    ``act_amax`` gets ``max(amax, floor) / 127``. Returns a new dict."""
    out = dict(params)
    fp_params = fp_params or {}
    sites = sorted(k[: -len(".act_amax")] for k in calib if k.endswith(".act_amax"))
    for site in sites:
        amax_ch = calib.get(f"{site}.act_amax_ch")
        if site.endswith("qkv_quant") and amax_ch is not None and f"{site}.act_smooth" in out:
            attn = site[: -len("qkv_quant")]
            projs = [attn + n for n in ("q_proj", "k_proj", "v_proj") if f"{attn}{n}.weight_q" in out]
            linears = projs
        elif amax_ch is not None and f"{site}.act_smooth" in out and f"{site}.weight_q" in out:
            linears = [site]
        else:
            out[f"{site}.act_scale"] = calib[f"{site}.act_amax"].float().clamp_min(floor) / 127.0
            continue
        s, c, refit = _smoothed(amax_ch, [(out[f"{n}.weight_q"], out[f"{n}.weight_scale"], fp_params.get(n))
                                          for n in linears], floor, smooth_alpha, outlier_ratio)
        for n, (q, sc) in zip(linears, refit):
            out[f"{n}.weight_q"], out[f"{n}.weight_scale"] = q, sc
        out[f"{site}.act_scale"], out[f"{site}.act_smooth"] = s, c
    return out


def calibration_sites(model: nn.Module, prefix: str = ""):
    """{module name: module} of the static sites under ``prefix``."""
    return {n: m for n, m in model.named_modules() if isinstance(m, _Calibrated) and n.startswith(prefix)}
