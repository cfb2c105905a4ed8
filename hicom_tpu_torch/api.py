"""Public inference API of the port: ``model_init``, ``load_model``, ``build_model``, ``HICom.generate``,
``mm_infer``, ``mm_infer_batch``, ``mm_serve``.

Port of ``hicom_tpu/api.py`` on one device (its mesh and ring paths are not
ported): ``mm_infer_batch`` runs same-shape videos or images as one
right-padded batch; ``mm_serve`` streams mixed requests through the
continuous-batching ``serve.ServeEngine``. ``load_model``
reads the reference's checkpoint layouts: SFT (decoder, SigLIP towers and
projector in one directory, or the towers from ``config.mm_vision_tower``),
pretrain (``model_base`` + ``mm_projector.bin``) and LoRA (``model_base`` +
``non_lora_trainables.bin`` + a peft adapter, merged at load).
Entry points run on the CUDA device unless the caller passes ``device="cpu"``;
without a card and without ``device`` they raise rather than fall back.
Weights are read by the port's own safetensors reader; ``transformers`` is
imported only inside ``load_model`` and ``model_init``, for the tokenizers.

Quantized serving (``models/quant.py``): ``load_model``'s ``load_8bit``,
``load_4bit``, ``dec_quant`` and ``load_w8a8_tower`` quantize a float
checkpoint at load, linear by linear on the model's device (codes bit-equal
to the JAX package's host converters, without a float copy of the model on
the card). Static ``w8a8s*`` modes keep fp16 host copies of the converted
weights until their one-time calibration (``HICom.calibrate_tower`` /
``calibrate_decoder``, run by ``generate`` on the first frames it sees), whose
SmoothQuant refit starts from them. ``model_init(...,
device_preprocess=True)`` preprocesses videos on the device
(``ops/preprocess.py``): the host only decodes frames.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from . import weights as W
from .config import HIComConfig, is_clip_tower, projector_qk_dim, tower_configs
from .constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN
from .data.prompts import tokenizer_multimodal_token
from .models import quant as Q
from .models.generate import generate_tokens, keyword_token_sequences
from .models.hicom import HIComModel


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA device; raises when a CUDA device is
    asked for (or implied) and there is none."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return device


def build_model(config: HIComConfig, device=None, seed: int = 0, std: float = 0.02) -> HIComModel:
    """A model with every weight drawn from N(0, std) by a seeded generator on
    ``device`` (no host copy of the weights is ever made). A quantized config
    draws the float model's weights in the float model's order, so the same
    seed gives the same float weights, and quantizes each converted linear's
    weight on ``device`` as it is drawn: no full float model is resident."""
    import dataclasses

    device = resolve_device(device)
    float_cfg = config.replace(
        text_config=dataclasses.replace(config.text_config, quantization=None),
        vision_config=dataclasses.replace(config.vision_config, quantization=None))
    with torch.device("meta"):
        model = HIComModel(config)
        plain = HIComModel(float_cfg) if float_cfg != config else model
    model.to_empty(device=device)
    gen = torch.Generator(device).manual_seed(seed)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in plain.named_parameters():
            if name in own:
                own[name].normal_(0.0, std, generator=gen)
            else:  # a converted linear's weight
                w = torch.empty(p.shape, dtype=p.dtype, device=device).normal_(0.0, std, generator=gen)
                model.get_submodule(name[: -len(".weight")]).set_weight(w)
                del w
        for m in model.modules():
            for buf in ("act_scale", "act_smooth"):
                if isinstance(getattr(m, buf, None), torch.Tensor):
                    getattr(m, buf).fill_(1.0)
    return model.eval()


def _as_frames(frames):
    """Frames as given when a tensor (kept on its device), else a numpy array."""
    return frames if isinstance(frames, torch.Tensor) else np.asarray(frames)


@dataclass
class HICom:
    """Loaded runtime: config + model on its device."""

    config: HIComConfig
    model: HIComModel
    guide_tokenizer: Any = None
    eos_token_id: Optional[int] = None
    cache_len: int = 4096
    # static-quant state: fp16 host copies of the converted weights by module
    # name (freed by the calibration they feed) and whether each part is calibrated
    fp_tower_weights: Optional[dict] = None
    fp_decoder_weights: Optional[dict] = None
    tower_calibrated: bool = False
    decoder_calibrated: bool = False

    @property
    def device(self) -> torch.device:
        return self.model.model.norm.weight.device

    def _to_dev(self, x, dt=None):
        """numpy or host data -> a tensor on the model's device; a tensor
        already there (and of ``dt``) is used as it is, without a copy."""
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype=dt)
        return torch.as_tensor(np.asarray(x), device=self.device, dtype=dt)

    def _calibrate(self, prefix: str, run, fp_weights: Optional[dict]) -> None:
        """Run ``run`` with the static sites under ``prefix`` in calibration
        mode, then write the scales :func:`models.quant.fill_act_scales`
        computes from what they recorded into the model."""
        model = self.model
        sites = Q.calibration_sites(model, prefix)
        for m in sites.values():
            m.reset_calibration()
            m.calibrate = True
        try:
            with torch.inference_mode():
                run()
        finally:
            for m in sites.values():
                m.calibrate = False
        calib = {}
        for name, m in sites.items():
            if m.act_amax is not None:
                calib[f"{name}.act_amax"], calib[f"{name}.act_amax_ch"] = m.act_amax.clone(), m.act_amax_ch.clone()
            m.reset_calibration()
        keys = [k for k in model.state_dict() if k.startswith(prefix) and
                k.endswith(("weight_q", "weight_scale", "act_scale", "act_smooth"))]
        with torch.no_grad():
            params = {k: model.get_buffer(k) for k in keys}
            for k, v in Q.fill_act_scales(params, calib, fp_params=fp_weights).items():
                if v is not params[k]:  # a site's new scales or refitted codes
                    params[k].copy_(v)

    def calibrate_tower(self, frames, guide_ids=None, modal: str = "video") -> None:
        """Fill a static-quant tower's activation scales (``w8a8s*``) from one
        calibration forward of the guide encoder, tower and projector over
        ``frames`` (b, t, 3, H, W); frees the fp16 weight copies it refits from."""
        model, dt = self.model, self.model.model.norm.weight.dtype
        f = self._to_dev(frames, dt)
        g = self._to_dev(guide_ids, torch.int64) if guide_ids is not None and self.config.guide_enabled() else None

        def run():
            ge = model.encode_guide(g) if g is not None else None
            model.encode_visual(f, ge, modal)

        self._calibrate(Q.TOWER_PREFIX, run, self.fp_tower_weights)
        self.fp_tower_weights = None
        self.tower_calibrated = True

    def calibrate_decoder(self, input_ids, frames, guide_ids=None, modal: str = "video") -> None:
        """Fill a static-quant decoder's activation scales (``w8a8s*``) from
        one calibration prefill through the real pipeline: guide encoder,
        tower and projector, splice, decoder and the last token's logits, as
        the JAX package runs it (no padding mask). Run after the tower's, so
        the visual tokens carry serving numerics."""
        model, dt = self.model, self.model.model.norm.weight.dtype
        ids = self._to_dev(input_ids, torch.int64)
        f = self._to_dev(frames, dt)
        g = self._to_dev(guide_ids, torch.int64) if guide_ids is not None and self.config.guide_enabled() else None

        def run():
            ge = model.encode_guide(g) if g is not None else None
            sp = model.embed_and_splice(ids, model.encode_visual(f, ge, modal))
            hidden = model.model(sp.embeds, sp.positions)
            model.logits(hidden[:, -1:])

        self._calibrate("model.layers.", run, self.fp_decoder_weights)
        self.fp_decoder_weights = None
        self.decoder_calibrated = True

    def _calibration_slice(self, frames, guide_ids):
        """The first 8 frames of the first row, and its guide ids."""
        f = _as_frames(frames)
        if f.ndim == 4:
            f = f[None]
        g = _as_frames(guide_ids)[:1] if guide_ids is not None else None
        return f[:1, : min(8, f.shape[1])], g

    def _maybe_autocalibrate(self, frames, guide_ids, modal: str) -> None:
        """A static-quant tower calibrates once, on the first frames it sees."""
        quant = self.config.vision_config.quantization
        if self.tower_calibrated or frames is None or not (quant or "").startswith("w8a8s"):
            return
        self.calibrate_tower(*self._calibration_slice(frames, guide_ids), modal=modal)

    def _maybe_autocalibrate_decoder(self, input_ids, frames, guide_ids, modal: str) -> None:
        """A static-quant decoder calibrates once, on the first multimodal
        prompt, after the tower."""
        quant = self.config.text_config.quantization
        if self.decoder_calibrated or frames is None or not (quant or "").startswith("w8a8s"):
            return
        f, g = self._calibration_slice(frames, guide_ids)
        self.calibrate_decoder(_as_frames(input_ids)[:1], f, guide_ids=g, modal=modal)

    def generate(
        self,
        input_ids: np.ndarray,
        frames=None,
        guide_ids: Optional[np.ndarray] = None,
        guide_mask: Optional[np.ndarray] = None,
        attention_mask: Optional[np.ndarray] = None,
        modal: str = "video",
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 0.2,
        top_p: float = 0.9,
        seed: int = 0,
        stop_sequences: tuple = (),
        visual_embeds=None,
        spec_decode: Optional[int] = None,
    ) -> np.ndarray:
        """(b, L) prompt ids with one modal sentinel -> (b, max_new_tokens) ids.
        ``frames`` may be a tensor already on the model's device (the device
        preprocessor's output): it is used as it is. ``visual_embeds`` (b, V,
        hidden), the tokens of an anyres image (:meth:`encode_anyres`), take
        the place of ``frames``. ``spec_decode`` (default: env
        ``HICOM_SPEC_DECODE``, else 0) drafts that many prompt-lookup tokens
        per decode step: greedy, unpadded b = 1 only, ignored otherwise."""
        if spec_decode is None:
            spec_decode = int(os.environ.get("HICOM_SPEC_DECODE", "0"))
        dev = self.device
        dtype = self.model.model.norm.weight.dtype
        if frames is not None:
            self._maybe_autocalibrate(frames, guide_ids, modal)
            self._maybe_autocalibrate_decoder(input_ids, frames, guide_ids, modal)
        temp = float(temperature) if do_sample else 0.0
        L = input_ids.shape[1]
        if visual_embeds is not None:
            V = visual_embeds.shape[1]
        else:
            V = self.model.visual_token_count(frames.shape[1], modal) if frames is not None else 0
        cache_len = self.cache_len_for(L, V, max_new_tokens)

        to_dev = self._to_dev
        gen = torch.Generator(dev).manual_seed(seed)
        multimodal = frames is not None or visual_embeds is not None
        out = generate_tokens(
            self.model, to_dev(input_ids, torch.int64), to_dev(frames, dtype), to_dev(guide_ids, torch.int64),
            to_dev(guide_mask), to_dev(attention_mask), to_dev(visual_embeds, dtype),
            modal=modal if multimodal else "text", max_new_tokens=max_new_tokens, temperature=temp,
            top_p=float(top_p), eos_token_id=int(self.eos_token_id), cache_len=cache_len,
            stop_sequences=tuple(stop_sequences), generator=gen, spec_k=int(spec_decode))
        return out.cpu().numpy()

    def cache_len_for(self, prompt_len: int, visual_tokens: int, max_new_tokens: int) -> int:
        """The KV cache ``generate`` takes: ``cache_len``, grown in steps of
        1024 slots for a long prompt (the spliced length is L - 1 + V)."""
        need = prompt_len + max(visual_tokens - 1, 0) + max_new_tokens + 8
        return self.cache_len if need <= self.cache_len else ((need + 1023) // 1024) * 1024

    def encode_anyres(self, crops, image_size, guide_ids=None, guide_mask=None) -> torch.Tensor:
        """(n, 3, H, W) crops of one anyres image (crop 0 the base image) of
        original ``image_size`` (width, height) -> (V, hidden) visual tokens
        on the model's device. The merge plan is host arithmetic on
        ``image_size``: nothing here waits for the device."""
        model, dt = self.model, self.model.model.norm.weight.dtype
        self._maybe_autocalibrate(_as_frames(crops)[:1][None], guide_ids, "image")
        with torch.inference_mode():
            ge = None
            if self.config.guide_enabled() and guide_ids is not None:
                ge = model.encode_guide(self._to_dev(guide_ids, torch.int64), self._to_dev(guide_mask))[0]
            return model.encode_visual_anyres(self._to_dev(crops, dt), tuple(image_size), ge)


def load_model(model_path: str, dtype: str = "bfloat16", cache_len: int = 4096, device=None,
               kv_cache_int8: bool = False, model_base: Optional[str] = None, load_8bit: bool = False,
               load_4bit: bool = False, dec_quant: Optional[str] = None, load_w8a8_tower=False) -> HICom:
    """Load a checkpoint directory onto ``device``: an SFT checkpoint, or with
    ``model_base`` (the base LLM directory) a pretrain artifact
    (``mm_projector.bin``) or a LoRA artifact (``adapter_config.json``), the
    towers of the last two read from ``config.mm_vision_tower``.

    Quantization, as the JAX package's ``load_model`` takes it: at most one of
    ``load_8bit`` (``dec_quant="int8"``), ``load_4bit`` (``"nf4"``) and
    ``dec_quant`` (``int8``, ``nf4``, ``w8a8``, ``w8a8_mlp``, ``w8a8s``,
    ``w8a8s_mlp``); ``load_w8a8_tower`` True for the tower's ``w8a8`` or a
    tower mode string. Static ``w8a8s*`` modes calibrate on the first frames
    ``generate`` sees."""
    import dataclasses

    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        raw_cfg = json.load(f)
    cfg = HIComConfig.from_hf_dict(raw_cfg)
    vision_cfg, guide_cfg = tower_configs(cfg.mm_vision_tower)
    cfg = cfg.replace(vision_config=vision_cfg, guide_text_config=guide_cfg, dtype=dtype,
                      projector_qk_dim=projector_qk_dim(vision_cfg))
    if load_w8a8_tower and is_clip_tower(cfg.mm_vision_tower):
        raise ValueError("load_w8a8_tower supports the SigLIP tower family")
    if sum(map(bool, (load_8bit, load_4bit, dec_quant))) > 1:
        raise ValueError("pick one decoder quantization (load_8bit / load_4bit / dec_quant)")
    dec_quant = "int8" if load_8bit else "nf4" if load_4bit else dec_quant
    tower_quant = (load_w8a8_tower if isinstance(load_w8a8_tower, str) else "w8a8") if load_w8a8_tower else None
    Q.check_modes(dec_quant, tower_quant)
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, kv_cache_int8=kv_cache_int8,
                                                      quantization=dec_quant),
                      vision_config=dataclasses.replace(cfg.vision_config, quantization=tower_quant))

    kind = cfg.projector.kind
    is_pretrain = os.path.exists(os.path.join(model_path, "mm_projector.bin"))
    is_lora = os.path.exists(os.path.join(model_path, "adapter_config.json"))
    tower_sd = {}
    if is_pretrain or is_lora:
        if model_base is None:
            raise ValueError(f"{model_path} is a {'pretrain' if is_pretrain else 'LoRA'} artifact: pass "
                             "model_base (the base LLM directory)")
        sd = W.decoder_state(W.load_hf_state_dict(model_base))
        if is_pretrain:
            proj_sd = W.load_torch_bin(os.path.join(model_path, "mm_projector.bin"))
        else:  # reference lora layout (model/__init__.py:91-138)
            nlt = os.path.join(model_path, "non_lora_trainables.bin")
            extra = W.load_torch_bin(nlt) if os.path.exists(nlt) else {}
            extra = {k.replace("base_model.model.", "").replace("model.model.", "model."): v for k, v in extra.items()}
            sd.update({k: v for k, v in extra.items() if "mm_projector" not in k and "vision_tower" not in k})
            proj_sd = {k: v for k, v in extra.items() if "mm_projector" in k}
        tower_sd = W.load_hf_state_dict(cfg.mm_vision_tower)
        sd.update(W.tower_state(tower_sd, guide=cfg.guide_enabled()))
        sd.update(W.convert_projector_state(proj_sd, kind) if proj_sd else {})
        if "model.image_newline" in proj_sd:  # an anyres projector's artifact carries the newline
            sd["model.image_newline"] = proj_sd["model.image_newline"]
        if is_lora:
            lora, alpha, rank = W.load_peft_adapter(model_path)
            sd = W.apply_lora(sd, lora, alpha=alpha, rank=rank)
    else:
        sd = W.load_hf_state_dict(model_path)
        if kind != "hicom":  # the reference's mean-pool keys (model.mm_projector.0.weight) move under layers.
            proj_sd = {k: sd.pop(k) for k in [k for k in sd if "mm_projector" in k]}
            sd.update(W.convert_projector_state(proj_sd, kind))
        if not any(k.startswith("model.vision_tower.") for k in sd):  # frozen tower: from its own directory
            tower_sd = W.load_hf_state_dict(cfg.mm_vision_tower)
            sd.update(W.tower_state(tower_sd, guide=cfg.guide_enabled()))
    # a clip-scale projector without its own scale takes the tower's (api.py:642-647); a CLIP
    # tower has no logit_bias, so this raises a KeyError as the JAX package does
    for side in [s for s in (cfg.use_clip_scale or "").split(",") if s]:
        if "logit_scale" in tower_sd and f"model.mm_projector.{side}_logit_scale" not in sd:
            sd[f"model.mm_projector.{side}_logit_scale"] = tower_sd["logit_scale"].reshape(())
            sd[f"model.mm_projector.{side}_logit_bias"] = tower_sd["logit_bias"].reshape(())
    # quantize at load (after any LoRA merge), linear by linear on the model's device
    fp_dec = fp_tower = None
    if dec_quant:
        fp_dec = Q.prune_fp_kernels(sd, dec_quant, targets=Q.decoder_quant_targets(dec_quant)) or None
        sd = Q.quantize_decoder_params(sd, dec_quant, device=device)
    if tower_quant:
        fp_tower = Q.prune_fp_kernels(sd, tower_quant) or None
        sd = Q.quantize_tower_params(sd, tower_quant, device=device)
    with torch.device("meta"):
        model = HIComModel(cfg)
    model.load_state_dict(W.model_state_dict(model, sd), strict=True, assign=True)
    del sd
    model = model.to(device).eval()

    guide_tok = None
    if cfg.guide_enabled():
        try:
            from transformers import AutoTokenizer

            guide_tok = AutoTokenizer.from_pretrained(cfg.mm_vision_tower)
        except (ImportError, OSError, ValueError, TypeError):
            # no transformers, or no tokenizer files (transformers 5 raises
            # TypeError for a SigLIP directory without its sentencepiece
            # model): callers pass guide_ids
            guide_tok = None
    eos = raw_cfg.get("eos_token_id", cfg.text_config.eos_token_id)
    if isinstance(eos, list):
        eos = eos[0]
    return HICom(config=cfg, model=model, guide_tokenizer=guide_tok, eos_token_id=eos, cache_len=cache_len,
                 fp_tower_weights=fp_tower, fp_decoder_weights=fp_dec)


def model_init(model_path: str, model_base: Optional[str] = None, device_preprocess: Optional[bool] = None,
               **kwargs):
    """The reference-compatible entry: (model, processor dict, tokenizer).

    ``kwargs`` go to :func:`load_model` (``device``, the quantization flags,
    ...). The tokenizer is read with ``transformers.AutoTokenizer`` from
    ``model_path`` when it holds one, else from ``model_base``.
    ``device_preprocess`` (default: env ``HICOM_DEVICE_PREPROCESS == "1"``)
    gives videos the device preprocessor (``ops/preprocess.py``; on the
    model's device, in its dtype) when ``image_aspect_ratio == "pad"``: the
    host only decodes frames and ``mm_infer`` takes the device tensor as it
    is. Images keep the host path."""
    from functools import partial

    from transformers import AutoTokenizer

    from .data.image import process_image
    from .data.processor import SiglipImagePreprocessor
    from .data.video import process_video
    from .models.hicom import torch_dtype

    model = load_model(model_path, model_base=model_base, **kwargs)
    tok_path = model_path if os.path.exists(os.path.join(model_path, "tokenizer_config.json")) else model_base
    tokenizer = AutoTokenizer.from_pretrained(tok_path)
    if tokenizer.pad_token is None and tokenizer.unk_token is not None:
        tokenizer.pad_token = tokenizer.unk_token

    cfg = model.config
    size = (cfg.vision_config.image_size, cfg.vision_config.image_size)
    image_processor = SiglipImagePreprocessor(size=size)
    if device_preprocess is None:
        device_preprocess = os.environ.get("HICOM_DEVICE_PREPROCESS", "") == "1"
    video_processor = image_processor
    if device_preprocess and cfg.image_aspect_ratio == "pad":
        from .ops.preprocess import DeviceSiglipPreprocessor

        video_processor = DeviceSiglipPreprocessor(size=size, out_dtype=torch_dtype(cfg.dtype), device=model.device)
    processor = {
        "image": partial(process_image, processor=image_processor, aspect_ratio=cfg.image_aspect_ratio,
                         image_grid_pinpoints=cfg.image_grid_pinpoints, image_crop_resolution=None,
                         image_split_resolution=None),
        "video": partial(process_video, processor=video_processor, aspect_ratio=cfg.image_aspect_ratio,
                         num_frames=cfg.num_frames),
    }
    return model, processor, tokenizer


def _pad_to_bucket(ids, pad_id: int, bucket: int = 64):
    """Right-pad id rows, a (b, L) array or a list of ragged 1-D rows, to a
    shared multiple of ``bucket`` -> (ids, mask)."""
    rows = [np.asarray(r) for r in ids]
    L = max(len(r) for r in rows)
    target = max(bucket, ((L + bucket - 1) // bucket) * bucket)
    out = np.full((len(rows), target), pad_id, dtype=np.int64)
    mask = np.zeros((len(rows), target), dtype=bool)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        mask[i, : len(r)] = True
    return out, mask


def _trim_at_keywords(text: str, keywords) -> str:
    """Cut ``text`` at the earliest occurrence of any stop keyword."""
    for kw in keywords:
        if kw and kw in text:
            text = text.split(kw)[0]
    return text.strip()


def mm_infer(image_or_video, instruct, model: HICom, tokenizer, modal: str = "video", image_size=None,
             **kwargs) -> str:
    """Single-sample multimodal generation -> response string.

    ``image_or_video``: preprocessed (t, 3, H, W) or (3, H, W) pixels (a
    tensor on the model's device is used as it is), None for
    ``modal="text"``. Guide-mode models take ``guide_ids`` (and ``guide_mask``)
    or ``guide_instruct`` for the guide tokenizer. A multi-crop image under an
    anyres aspect ratio is merged by :meth:`HICom.encode_anyres`, which
    needs the original ``image_size`` (width, height).
    """
    if modal == "image":
        modal_token = DEFAULT_IMAGE_TOKEN
    elif modal == "video":
        modal_token = DEFAULT_VIDEO_TOKEN
    elif modal == "text":
        modal_token = ""
    else:
        raise ValueError(f"unsupported modal: {modal}")

    frames = None
    if modal != "text":
        frames = _as_frames(image_or_video)
        if frames.ndim == 3:
            frames = frames[None]
        frames = frames[None]  # (1, t, 3, H, W)
    if isinstance(instruct, str):
        message = [{"role": "user", "content": modal_token + "\n" + instruct}]
    elif isinstance(instruct, list):
        message = copy.deepcopy(instruct)
        message[0]["content"] = modal_token + "\n" + message[0]["content"]
    else:
        raise ValueError(f"unsupported instruct type: {type(instruct)}")

    prompt = tokenizer.apply_chat_template(message, tokenize=False, add_generation_prompt=True)
    ids = np.asarray(tokenizer_multimodal_token(prompt, tokenizer, modal_token, return_tensors="np"))[None]
    pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0
    ids, mask = _pad_to_bucket(ids, pad_id)

    guide_ids = guide_mask = None
    if model.config.guide_enabled() and frames is not None:
        if "guide_ids" in kwargs:
            guide_ids = np.asarray(kwargs["guide_ids"])
            guide_mask = kwargs.get("guide_mask")
        else:
            if model.guide_tokenizer is None:
                raise ValueError("guide tokenizer unavailable; pass guide_ids")
            enc = model.guide_tokenizer(kwargs["guide_instruct"], padding="max_length", truncation=True,
                                        max_length=model.config.guide_text_config.max_position_embeddings,
                                        return_tensors="np")
            guide_ids = enc["input_ids"]
            guide_mask = enc.get("attention_mask")

    visual_embeds = None
    if modal == "image" and frames is not None and frames.shape[1] > 1 and "anyres" in (
            model.config.image_aspect_ratio or ""):
        # a multi-crop anyres image: the merged tokens' count depends on image_size
        visual_embeds = model.encode_anyres(frames[0], image_size, guide_ids, guide_mask)[None]
        frames = None

    stop_strings = list(kwargs.get("stop_strings", ()))
    out = model.generate(
        ids, frames=frames, guide_ids=guide_ids, guide_mask=guide_mask, attention_mask=mask, modal=modal,
        visual_embeds=visual_embeds,
        max_new_tokens=kwargs.get("max_new_tokens", 2048), do_sample=kwargs.get("do_sample", False),
        temperature=kwargs.get("temperature", 0.2), top_p=kwargs.get("top_p", 0.9),
        stop_sequences=keyword_token_sequences(stop_strings, tokenizer),
    )
    text = tokenizer.batch_decode(out, skip_special_tokens=True)[0].strip()
    eos_str = tokenizer.decode([model.eos_token_id], skip_special_tokens=False)
    return _trim_at_keywords(text, [eos_str] + stop_strings)


def _chat_ids(instruct: str, tokenizer, modal_token: str) -> np.ndarray:
    """One user turn (the modal token, a newline, the instruction) through the
    chat template -> its prompt ids with the modal sentinel."""
    content = (modal_token + "\n" if modal_token else "") + instruct
    prompt = tokenizer.apply_chat_template([{"role": "user", "content": content}], tokenize=False,
                                           add_generation_prompt=True)
    return np.asarray(tokenizer_multimodal_token(prompt, tokenizer, modal_token, return_tensors="np"))


def mm_infer_batch(tensors, instructs, model: HICom, tokenizer, modal: str = "video", guide_instructs=None,
                   **kwargs) -> list:
    """Batched multimodal generation: N same-shape videos or images (each
    (t, 3, H, W) pixels) as one right-padded batch through one prefill and
    decode -> N response strings. Guide-mode models take ``guide_instructs``
    (or ``guide_ids`` / ``guide_mask``)."""
    if modal not in ("image", "video"):
        raise ValueError(f"mm_infer_batch takes images or videos, not {modal!r}")
    modal_token = DEFAULT_IMAGE_TOKEN if modal == "image" else DEFAULT_VIDEO_TOKEN
    if all(isinstance(t, torch.Tensor) for t in tensors):
        frames = torch.stack(list(tensors))
    else:
        frames = np.stack([np.asarray(t) for t in tensors])  # (b, t, 3, H, W)
    pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0
    ids, mask = _pad_to_bucket([_chat_ids(i, tokenizer, modal_token) for i in instructs], pad_id)

    guide_ids = kwargs.pop("guide_ids", None)
    guide_mask = kwargs.pop("guide_mask", None)
    if model.config.guide_enabled() and guide_ids is None:
        if guide_instructs is None or model.guide_tokenizer is None:
            raise ValueError("a guide-mode model needs guide_instructs (and its guide tokenizer) or guide_ids")
        enc = model.guide_tokenizer(list(guide_instructs), padding="max_length", truncation=True,
                                    max_length=model.config.guide_text_config.max_position_embeddings,
                                    return_tensors="np")
        guide_ids = enc["input_ids"]
        guide_mask = enc.get("attention_mask")

    stop_strings = list(kwargs.get("stop_strings", ()))
    out = model.generate(
        ids, frames=frames, guide_ids=guide_ids, guide_mask=guide_mask, attention_mask=mask, modal=modal,
        max_new_tokens=kwargs.get("max_new_tokens", 64), do_sample=kwargs.get("do_sample", False),
        temperature=kwargs.get("temperature", 0.2), top_p=kwargs.get("top_p", 0.9),
        stop_sequences=keyword_token_sequences(stop_strings, tokenizer))
    texts = tokenizer.batch_decode(out, skip_special_tokens=True)
    eos_str = tokenizer.decode([model.eos_token_id], skip_special_tokens=False)
    return [_trim_at_keywords(t, [eos_str] + stop_strings) for t in texts]


def serve_engine(model: HICom, tokenizer, n_slots: int = 4, cache_len: Optional[int] = None, sync_steps: int = 16,
                 prompt_buckets=(64, 128, 256, 512), **kwargs):
    """The :class:`serve.ServeEngine` that :func:`mm_serve` runs, on the
    model's device, with the shared kwargs of :func:`mm_serve`."""
    from .serve import ServeEngine

    do_sample = kwargs.get("do_sample", False)
    gcfg = model.config.guide_text_config
    return ServeEngine(
        model.model, n_slots=n_slots, cache_len=cache_len or model.cache_len, prompt_buckets=tuple(prompt_buckets),
        guide_len=gcfg.max_position_embeddings if gcfg is not None else 32, sync_steps=sync_steps,
        temperature=(kwargs.get("temperature", 0.2) if do_sample else 0.0), top_p=kwargs.get("top_p", 0.9),
        eos_token_id=model.eos_token_id,
        pad_token_id=tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0,
        # speculative serving (greedy only): the kwarg wins, the environment is the default
        spec_k=0 if do_sample else int(kwargs.get("spec_k", os.environ.get("HICOM_SPEC_DECODE", "0"))),
        device=model.device, cuda_graphs=kwargs.get("cuda_graphs"))


def serve_request(sample: dict, model: HICom, tokenizer, modal: str = "video", guide_len: int = 32,
                  stop_sequences: tuple = (), max_new_tokens: int = 128):
    """One :func:`mm_serve` sample -> its :class:`serve.GenRequest`: the chat
    prompt's ids with the modal sentinel, the frames and the guide ids."""
    from .serve import GenRequest

    s_modal = sample.get("modal", modal)
    tensor = sample.get("tensor")
    if s_modal == "text" or tensor is None:
        s_modal, modal_token, frames = "text", "", None
    else:
        modal_token = DEFAULT_IMAGE_TOKEN if s_modal == "image" else DEFAULT_VIDEO_TOKEN
        frames = _as_frames(tensor)
        if frames.ndim == 3:
            frames = frames[None]
    guide_ids = guide_mask = None
    if model.config.guide_enabled() and frames is not None:
        if "guide_ids" in sample:
            guide_ids = np.asarray(sample["guide_ids"]).reshape(-1)
        else:
            if model.guide_tokenizer is None:
                raise ValueError("guide tokenizer unavailable; pass guide_ids")
            enc = model.guide_tokenizer(sample["guide_instruct"], padding="max_length", truncation=True,
                                        max_length=guide_len, return_tensors="np")
            guide_ids = enc["input_ids"][0]
            am = enc.get("attention_mask")
            guide_mask = am[0].astype(bool) if am is not None else None
    return GenRequest(input_ids=_chat_ids(sample["instruct"], tokenizer, modal_token), frames=frames,
                      guide_ids=guide_ids, guide_mask=guide_mask, modal=s_modal,
                      max_new_tokens=sample.get("max_new_tokens", max_new_tokens), stop_sequences=stop_sequences)


def mm_serve(samples, model: HICom, tokenizer, modal: str = "video", n_slots: int = 4, cache_len: Optional[int] = None,
             sync_steps: int = 16, prompt_buckets=(64, 128, 256, 512), **kwargs) -> list:
    """Continuous-batching generation over mixed requests -> response strings
    in submission order: the requests stream through ``n_slots`` resident
    sequences of one :class:`serve.ServeEngine` (:func:`serve_engine`), and
    a finished slot is refilled from the queue at once.

    ``samples``: dicts with ``instruct`` (str) and optionally ``tensor``
    (preprocessed (t, 3, H, W) pixels, or a tensor on the model's device;
    None or absent: text only), ``modal``, ``guide_instruct`` / ``guide_ids``,
    ``max_new_tokens``. Shared kwargs: ``max_new_tokens``, ``do_sample``,
    ``temperature``, ``top_p``, ``stop_strings``, ``spec_k`` (default: env
    ``HICOM_SPEC_DECODE``; greedy only) and ``cuda_graphs`` (the engine's)."""
    stop_strings = list(kwargs.get("stop_strings", ()))
    stop_seqs = keyword_token_sequences(stop_strings, tokenizer)
    engine = serve_engine(model, tokenizer, n_slots, cache_len, sync_steps, prompt_buckets, **kwargs)
    order = [engine.submit(serve_request(s, model, tokenizer, modal, engine.guide_len, stop_seqs,
                                         kwargs.get("max_new_tokens", 128))) for s in samples]
    results = engine.run()
    eos_str = tokenizer.decode([model.eos_token_id], skip_special_tokens=False)
    return [_trim_at_keywords(tokenizer.decode(results[rid].tokens, skip_special_tokens=True).strip(),
                              [eos_str] + stop_strings) for rid in order]
