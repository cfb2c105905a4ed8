"""Public inference API of the port: ``load_model``, ``build_model``, ``HICom.generate``, ``mm_infer``.

Port of the single-request surface of ``hicom_tpu/api.py``. ``load_model``
reads the reference's checkpoint layouts: SFT (decoder, SigLIP towers and
projector in one directory, or the towers from ``config.mm_vision_tower``),
pretrain (``model_base`` + ``mm_projector.bin``) and LoRA (``model_base`` +
``non_lora_trainables.bin`` + a peft adapter, merged at load).
Entry points run on the CUDA device unless the caller passes ``device="cpu"``;
without a card and without ``device`` they raise rather than fall back.
Weights are read by the port's own safetensors reader; ``transformers`` is
imported only inside ``load_model``, for the guide tokenizer.
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
from .config import HIComConfig, tower_configs
from .constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN
from .data.prompts import tokenizer_multimodal_token
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
    ``device`` (no host copy of the weights is ever made)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = HIComModel(config)
    model.to_empty(device=device)
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, std, generator=gen)
    return model.eval()


@dataclass
class HICom:
    """Loaded runtime: config + model on its device."""

    config: HIComConfig
    model: HIComModel
    guide_tokenizer: Any = None
    eos_token_id: Optional[int] = None
    cache_len: int = 4096

    @property
    def device(self) -> torch.device:
        return self.model.model.norm.weight.device

    def generate(
        self,
        input_ids: np.ndarray,
        frames: Optional[np.ndarray] = None,
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
    ) -> np.ndarray:
        """(b, L) prompt ids with one modal sentinel -> (b, max_new_tokens) ids."""
        dev = self.device
        dtype = self.model.model.norm.weight.dtype
        temp = float(temperature) if do_sample else 0.0
        L = input_ids.shape[1]
        V = self.model.visual_token_count(frames.shape[1], modal) if frames is not None else 0
        # grow the KV cache for long prompts: the spliced length is L - 1 + V
        need = L + max(V - 1, 0) + max_new_tokens + 8
        cache_len = self.cache_len if need <= self.cache_len else ((need + 1023) // 1024) * 1024

        def to_dev(x, dt=None):
            return None if x is None else torch.as_tensor(np.asarray(x), device=dev, dtype=dt)

        gen = torch.Generator(dev).manual_seed(seed)
        out = generate_tokens(
            self.model, to_dev(input_ids, torch.int64), to_dev(frames, dtype), to_dev(guide_ids, torch.int64),
            to_dev(guide_mask), to_dev(attention_mask),
            modal=modal if frames is not None else "text", max_new_tokens=max_new_tokens, temperature=temp,
            top_p=float(top_p), eos_token_id=int(self.eos_token_id), cache_len=cache_len,
            stop_sequences=tuple(stop_sequences), generator=gen)
        return out.cpu().numpy()


def load_model(model_path: str, dtype: str = "bfloat16", cache_len: int = 4096, device=None,
               kv_cache_int8: bool = False, model_base: Optional[str] = None) -> HICom:
    """Load a checkpoint directory onto ``device``: an SFT checkpoint, or with
    ``model_base`` (the base LLM directory) a pretrain artifact
    (``mm_projector.bin``) or a LoRA artifact (``adapter_config.json``), the
    towers of the last two read from ``config.mm_vision_tower``."""
    import dataclasses

    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        raw_cfg = json.load(f)
    cfg = HIComConfig.from_hf_dict(raw_cfg)
    vision_cfg, guide_cfg = tower_configs(cfg.mm_vision_tower)
    cfg = cfg.replace(vision_config=vision_cfg, guide_text_config=guide_cfg, dtype=dtype)
    if kv_cache_int8:
        cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, kv_cache_int8=True))

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
        sd.update(W.convert_projector_state(proj_sd) if proj_sd else {})
        if is_lora:
            lora, alpha, rank = W.load_peft_adapter(model_path)
            sd = W.apply_lora(sd, lora, alpha=alpha, rank=rank)
    else:
        sd = W.load_hf_state_dict(model_path)
        if not any(k.startswith("model.vision_tower.") for k in sd):  # frozen tower: from its own directory
            tower_sd = W.load_hf_state_dict(cfg.mm_vision_tower)
            sd.update(W.tower_state(tower_sd, guide=cfg.guide_enabled()))
    # a clip-scale projector without its own scale takes the SigLIP tower's (api.py:642-647)
    for side in [s for s in (cfg.use_clip_scale or "").split(",") if s]:
        if "logit_scale" in tower_sd and f"model.mm_projector.{side}_logit_scale" not in sd:
            sd[f"model.mm_projector.{side}_logit_scale"] = tower_sd["logit_scale"].reshape(())
            sd[f"model.mm_projector.{side}_logit_bias"] = tower_sd["logit_bias"].reshape(())
    with torch.device("meta"):
        model = HIComModel(cfg)
    model.load_state_dict(W.model_state_dict(model, sd), strict=True, assign=True)
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
    return HICom(config=cfg, model=model, guide_tokenizer=guide_tok, eos_token_id=eos, cache_len=cache_len)


def _pad_to_bucket(ids: np.ndarray, pad_id: int, bucket: int = 64):
    """Right-pad (b, L) id rows to a multiple of ``bucket`` -> (ids, mask)."""
    b, L = ids.shape
    target = max(bucket, ((L + bucket - 1) // bucket) * bucket)
    out = np.full((b, target), pad_id, dtype=np.int64)
    out[:, :L] = ids
    mask = np.zeros((b, target), dtype=bool)
    mask[:, :L] = True
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

    ``image_or_video``: preprocessed (t, 3, H, W) or (3, H, W) pixels, None for
    ``modal="text"``. Guide-mode models take ``guide_ids`` (and ``guide_mask``)
    or ``guide_instruct`` for the guide tokenizer. A multi-crop anyres image
    (and any ``image_size``, which only the anyres merge reads) raises until
    the anyres merge is ported.
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
        frames = np.asarray(image_or_video)
        if frames.ndim == 3:
            frames = frames[None]
        frames = frames[None]  # (1, t, 3, H, W)
    anyres = frames is not None and modal == "image" and frames.shape[1] > 1 and "anyres" in (
        model.config.image_aspect_ratio or "")
    if anyres or image_size is not None:
        raise NotImplementedError("multi-crop anyres images need encode_anyres (ROADMAP Queue 1 item 4)")

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

    stop_strings = list(kwargs.get("stop_strings", ()))
    out = model.generate(
        ids, frames=frames, guide_ids=guide_ids, guide_mask=guide_mask, attention_mask=mask, modal=modal,
        max_new_tokens=kwargs.get("max_new_tokens", 2048), do_sample=kwargs.get("do_sample", False),
        temperature=kwargs.get("temperature", 0.2), top_p=kwargs.get("top_p", 0.9),
        stop_sequences=keyword_token_sequences(stop_strings, tokenizer),
    )
    text = tokenizer.batch_decode(out, skip_special_tokens=True)[0].strip()
    eos_str = tokenizer.decode([model.eos_token_id], skip_special_tokens=False)
    return _trim_at_keywords(text, [eos_str] + stop_strings)
