"""Supervised training data pipeline: YAML mixtures, chat-template masking,
guide-format splitting, batching.

A copy of ``hicom_tpu/train/dataset.py`` (the reference dataset/collator,
``train.py:159-555``), numpy-native, held to it exactly by
``tests/test_torch_data.py``:

* YAML mixtures with ``sampling_strategy`` all / first:N / end:N / random:N%.
* guide mode splits multi-turn conversations into per-answer samples and
  supervises only the last turn (``train.py:227-233``).
* corrupt media → retry a random other index (``train.py:432-436``).
* batches are grouped by modality and padded to a shared length bucket, in
  the JAX package's order for the same seed.

Anyres images train in batches of one merge plan (:meth:`SupervisedDataset.
batch_key`, the plan read from the image's header) and multi-image rows as
(b, K, 3, H, W) frames, as in the JAX package. One process reads the data:
the multi-host slicing and the fixed lengths, frame counts and multi-image
flag of the JAX package (``Collator.fixed_*``) are not carried over.
"""

from __future__ import annotations

import copy
import json
import math
import os
import random
import traceback
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX, MODAL_INDEX_MAP, NUM_FRAMES
from ..data.image import process_image
from ..data.prompts import convert_guide_format, extract_guided_prompt, tokenizer_multimodal_token
from ..data.video import process_video


# --------------------------------------------------------------------------- #
# Tokenization / label masking
# --------------------------------------------------------------------------- #


def preprocess_plain(sources, tokenizer, modal_token: str):
    """Pretrain preprocessing (``train.py:159-185``): caption = everything
    after the modal token; only the modal token is masked."""
    input_ids, labels = [], []
    for source in sources:
        assert len(source) == 2 and modal_token in source[0]["value"]
        conversation = " ".join(s["value"] for s in source)
        ids = np.asarray(tokenizer_multimodal_token(conversation, tokenizer, modal_token), dtype=np.int64)
        lab = ids.copy()
        lab[ids == MODAL_INDEX_MAP[modal_token]] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(lab)
    return input_ids, labels


def preprocess_chat(sources, tokenizer, modal_token: Optional[str], process_guided: bool = False):
    """Chat-template preprocessing with per-turn label masking
    (``train.py:188-238``). ``process_guided`` supervises only the final turn."""
    roles = {"human": "user", "gpt": "assistant"}
    input_ids, labels = [], []
    for source in sources:
        if roles[source[0]["from"]] != "user":
            source = source[1:]
        message = [{"role": roles[s["from"]], "content": s["value"]} for s in source]
        conversation = tokenizer.apply_chat_template(message, tokenize=False, add_generation_prompt=False)
        ids = np.asarray(tokenizer_multimodal_token(conversation, tokenizer, modal_token), dtype=np.int64)
        lab = ids.copy()

        assert len(source) % 2 == 0, f"Invalid conversation length {len(source)}"
        cur = 0
        history: List[dict] = []
        for idx in range(1, len(source), 2):
            pair = [
                {"role": roles[source[idx - 1]["from"]], "content": source[idx - 1]["value"]},
                {"role": roles[source[idx]["from"]], "content": source[idx]["value"]},
            ]
            instruction = tokenizer.apply_chat_template(history + pair[:1], tokenize=False, add_generation_prompt=True)
            convo = tokenizer.apply_chat_template(history + pair, tokenize=False, add_generation_prompt=False)
            ilen = len(tokenizer_multimodal_token(instruction, tokenizer, modal_token))
            clen = len(tokenizer_multimodal_token(convo, tokenizer, modal_token))
            if process_guided and idx != len(source) - 1:
                lab[cur:clen] = IGNORE_INDEX  # earlier turns fully unsupervised
            else:
                lab[cur:ilen] = IGNORE_INDEX
            cur = clen
            history += pair
        input_ids.append(ids)
        labels.append(lab)
    return input_ids, labels


def normalize_modal_tag(conversations, modal_token: str):
    """Move the modal tag to the head of the first message (``train.py:241-262``)."""
    for source in conversations:
        for sentence in source:
            if modal_token in sentence["value"]:
                v = sentence["value"].replace(modal_token, "").strip()
                sentence["value"] = (modal_token + "\n" + v).strip()
    return conversations


# --------------------------------------------------------------------------- #
# Dataset
# --------------------------------------------------------------------------- #


@dataclass
class DataArguments:
    data_path: List[str] = field(default_factory=list)
    data_folder: Optional[str] = None
    image_aspect_ratio: str = "pad"
    image_grid_pinpoints: Optional[str] = None
    image_crop_resolution: Optional[int] = None
    image_split_resolution: Optional[int] = None
    num_frames: Optional[int] = None
    use_guide: Optional[str] = None
    is_pretraining: bool = False
    is_multimodal: bool = True
    image_size: int = 384
    patch_size: int = 14  # tower patch size (anyres plan geometry)
    mm_patch_merge_type: str = "flat"  # anyres merge (spatial_unpad etc.)
    model_max_length: int = 4096
    length_bucket: int = 64  # pad batches up to a multiple of this length


def load_mixture(data_path: List[str], seed: int = 42) -> List[dict]:
    """YAML mixtures with sampling strategies, or plain json/jsonl files."""
    rng = random.Random(seed)
    out: List[dict] = []

    def load_file(path):
        with open(path) as f:
            if path.endswith(".jsonl"):
                return [json.loads(line) for line in f if line.strip()]
            return json.load(f)

    if len(data_path) == 1 and data_path[0].endswith(".yaml"):
        import yaml

        with open(data_path[0]) as f:
            spec = yaml.safe_load(f)
        for ds in spec.get("datasets", []):
            rows = load_file(ds["json_path"])
            root = ds.get("data_root")
            if root is not None:
                for d in rows:
                    if "image" in d:
                        d["image"] = os.path.join(root, d["image"])
                    elif "video" in d:
                        d["video"] = os.path.join(root, d["video"])
            strategy = ds.get("sampling_strategy", "all")
            n = None
            if ":" in strategy:
                strategy, num = strategy.split(":")
                n = math.ceil(int(num[:-1]) * len(rows) / 100) if "%" in num else int(num)
            if strategy == "first":
                rows = rows[:n]
            elif strategy == "end":
                rows = rows[-n:]
            elif strategy == "random":
                rng.shuffle(rows)
                rows = rows[:n]
            elif strategy != "all":
                raise ValueError(f"unsupported sampling strategy: {strategy}")
            out.extend(rows)
    else:
        for dp in data_path:
            out.extend(load_file(dp))
    return out


def split_guide_format(rows: List[dict]) -> List[dict]:
    """Guide mode: one sample per assistant answer (``train.py:348-379``);
    rows with an odd number of turns are dropped."""
    return [sample for row in rows for sample in (convert_guide_format(row) or [])]


class SupervisedDataset:
    def __init__(self, tokenizer, data_args: DataArguments, image_processor, video_processor=None):
        self.tokenizer = tokenizer
        self.args = data_args
        self.image_processor = image_processor
        self.rows = load_mixture(data_args.data_path)
        if data_args.use_guide not in (None, "off"):
            self.rows = split_guide_format(self.rows)
        self._plan_cache: Dict[int, Any] = {}

    def __len__(self):
        return len(self.rows)

    @property
    def modality_lengths(self) -> List[int]:
        """Word-count lengths, negative for non-image samples (reference
        ``lengths``/``modality_lengths``, hicom_trainer.py:190-221 consumers)."""
        out = []
        for sample in self.rows:
            n = sum(len(c["value"].split()) for c in sample["conversations"])
            out.append(n if "image" in sample else -n)
        return out

    def modality_of(self, idx: int) -> str:
        row = self.rows[idx]
        return "image" if "image" in row else ("video" if "video" in row else "text")

    @property
    def _anyres_train(self) -> bool:
        aspect = self.args.image_aspect_ratio or ""
        return "anyres" in aspect and (self.args.mm_patch_merge_type or "flat").startswith("spatial")

    def anyres_plan_of(self, idx: int):
        """The merge plan of a single-image anyres sample (None otherwise),
        from the image header alone (no pixel decode); memoized."""
        if not self._anyres_train:
            return None
        if idx not in self._plan_cache:
            self._plan_cache[idx] = self._compute_anyres_plan(idx)
        return self._plan_cache[idx]

    def _compute_anyres_plan(self, idx: int):
        row = self.rows[idx]
        if "image" not in row or isinstance(row["image"], list):
            return None
        from PIL import Image

        path = row["image"]
        if self.args.data_folder:
            path = os.path.join(self.args.data_folder, path)
        try:
            with Image.open(path) as im:
                size = im.size  # (width, height), header only
        except Exception:
            return None
        return plan_for(size, self.args)

    def batch_key(self, idx: int):
        """Batches are uniform in (modality, anyres plan)."""
        return (self.modality_of(idx), self.anyres_plan_of(idx))

    def __getitem__(self, i: int) -> Dict[str, Any]:
        sample = self.rows[i]
        args = self.args
        guide_on = args.use_guide not in (None, "off")
        num_frames = args.num_frames if args.num_frames is not None else NUM_FRAMES

        frames = None
        modal_token = None
        guided_prompt = ""
        num_images = 1
        if "image" in sample:
            files = sample["image"] if isinstance(sample["image"], list) else [sample["image"]]
            num_images = len(files)
            if args.data_folder:
                files = [os.path.join(args.data_folder, f) for f in files]
            try:
                frames, _sizes = process_image(
                    files, self.image_processor, args.image_aspect_ratio,
                    args.image_grid_pinpoints, args.image_crop_resolution, args.image_split_resolution,
                )
            except Exception:
                traceback.print_exc()
                return self[random.randint(0, len(self.rows) - 1)]
            modal_token = "<image>"
        elif "video" in sample:
            path = sample["video"]
            if args.data_folder:
                path = os.path.join(args.data_folder, path)
            try:
                frames = process_video(path, self.image_processor, aspect_ratio=args.image_aspect_ratio,
                                       num_frames=num_frames)
            except Exception:
                traceback.print_exc()
                return self[random.randint(0, len(self.rows) - 1)]
            modal_token = "<video>"

        conversations = copy.deepcopy([sample["conversations"]])
        if modal_token is not None:
            if guide_on:
                guided_prompt = extract_guided_prompt(conversations[0][-2]["value"])
            conversations = normalize_modal_tag(conversations, modal_token)
        elif args.is_multimodal:
            frames = np.zeros((1, 3, args.image_size, args.image_size), dtype=np.float32)

        if args.is_pretraining:
            ids, labels = preprocess_plain(conversations, self.tokenizer, modal_token)
        else:
            process_guided = guide_on and modal_token in ("<image>", "<video>")
            ids, labels = preprocess_chat(conversations, self.tokenizer, modal_token, process_guided)

        out = {
            "input_ids": ids[0][: args.model_max_length],
            "labels": labels[0][: args.model_max_length],
            "frames": frames,
            "modal": "image" if modal_token == "<image>" else ("video" if modal_token == "<video>" else "text"),
            "guided_prompt": guided_prompt,
            # K>1 ⇔ a list under "image": one crop per file, K sentinels in the
            # text (reference emits one batch['images'] entry per file,
            # train.py:525-530). Single-image anyres crops keep num_images=1.
            "num_images": num_images,
        }
        if "image" in sample and num_images == 1:
            out["image_size"] = tuple(_sizes[0])  # original (width, height)
        return out


# --------------------------------------------------------------------------- #
# Collator + modality/length-grouped batching
# --------------------------------------------------------------------------- #


def plan_for(image_size, args: DataArguments):
    """The anyres merge plan of an image of original ``image_size`` under the data arguments."""
    from ..models.anyres import make_anyres_plan

    cfg = SimpleNamespace(mm_patch_merge_type=args.mm_patch_merge_type, image_aspect_ratio=args.image_aspect_ratio,
                          image_grid_pinpoints=args.image_grid_pinpoints)
    return make_anyres_plan(image_size, cfg, args.image_size, hw=args.image_size // args.patch_size)


@dataclass
class Collator:
    tokenizer: Any
    data_args: DataArguments
    guide_tokenizer: Any = None

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        pad_id = self.tokenizer.pad_token_id or 0
        bucket = self.data_args.length_bucket
        max_len = max(len(x["input_ids"]) for x in instances)
        max_len = min(math.ceil(max_len / bucket) * bucket, self.data_args.model_max_length)

        b = len(instances)
        input_ids = np.full((b, max_len), pad_id, dtype=np.int64)
        labels = np.full((b, max_len), IGNORE_INDEX, dtype=np.int64)
        mask = np.zeros((b, max_len), dtype=bool)
        for i, inst in enumerate(instances):
            ids = inst["input_ids"][:max_len]
            input_ids[i, : len(ids)] = ids
            labels[i, : len(ids)] = inst["labels"][:max_len]
            mask[i, : len(ids)] = True

        batch: Dict[str, Any] = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": mask,
        }
        # uniform-modality batches: stack frames (t must match across rows)
        frames = [x["frames"] for x in instances if x["frames"] is not None]
        if frames:
            modal = next(x["modal"] for x in instances if x["modal"] != "text")
            multi = modal == "image" and any(x.get("num_images", 1) > 1 for x in instances)
            t = max(f.shape[0] for f in frames)
            stacked = np.zeros((b, t) + frames[0].shape[1:], dtype=np.float32)
            for i, inst in enumerate(instances):
                f = inst["frames"]
                if f is not None:
                    stacked[i, : f.shape[0]] = f
            batch["frames"] = stacked
            batch["modal"] = modal
            # multi-image rows: (b, K, 3, H, W) with one sentinel per image
            # (reference emits one batch['images'] entry per file,
            # train.py:525-530); rows with fewer images zero-pad to K and the
            # K-sentinel splice drops the surplus embeds.
            batch["multi_image"] = multi
            # anyres batches: the iterator grouped rows by plan; the plan keys the train step
            args = self.data_args
            if (modal == "image" and not multi and "anyres" in (args.image_aspect_ratio or "")
                    and (args.mm_patch_merge_type or "flat").startswith("spatial")):
                plans = {plan_for(inst["image_size"], args) for inst in instances if "image_size" in inst}
                if len(plans) != 1:
                    raise ValueError(f"an anyres batch mixes merge plans: {plans}")
                batch["anyres_plan"] = plans.pop()
        if self.guide_tokenizer is not None:
            enc = self.guide_tokenizer(
                [x["guided_prompt"] for x in instances],
                padding="max_length", truncation=True, return_tensors="np",
            )
            batch["guide_ids"] = enc["input_ids"]
            if "attention_mask" in enc:
                batch["guide_mask"] = enc["attention_mask"]
        return batch


def split_to_even_chunks(indices, lengths, num_chunks):
    """Greedy balanced split (reference hicom_trainer.py:129-148)."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    num_per = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunk_lengths = [0] * num_chunks
    for idx in indices:
        shortest = chunk_lengths.index(min(chunk_lengths))
        chunks[shortest].append(idx)
        chunk_lengths[shortest] += lengths[idx]
        if len(chunks[shortest]) == num_per:
            chunk_lengths[shortest] = float("inf")
    return chunks


def modality_length_grouped_indices(lengths: List[int], batch_size: int, world_size: int, seed: int = 0):
    """Group by modality then by length into megabatches
    (reference hicom_trainer.py:151-187)."""
    rng = np.random.default_rng(seed)
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        perm = rng.permutation(len(lengths)).tolist()
        mega = batch_size * world_size
        megabatches = [perm[i : i + mega] for i in range(0, len(perm), mega)]
        megabatches = [sorted(m, key=lambda i: abs(lengths[i]), reverse=True) for m in megabatches]
        return [i for m in megabatches for chunk in split_to_even_chunks(m, [abs(l) for l in lengths], world_size) for i in chunk]

    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    out = []
    for group in (mm, lang):
        if not group:
            continue
        idxs = [i for i, _ in group]
        ls = {i: l for i, l in group}
        perm = rng.permutation(len(idxs))
        shuffled = [idxs[int(p)] for p in perm]
        mega = batch_size * world_size
        megabatches = [shuffled[i : i + mega] for i in range(0, len(shuffled), mega)]
        megabatches = [sorted(m, key=lambda i: ls[i], reverse=True) for m in megabatches]
        out.extend(i for m in megabatches for i in m)
    return out


def iter_batches(dataset: SupervisedDataset, collator: Collator, batch_size: int, seed: int = 0,
                 group_by_modality: bool = True):
    """Epoch iterator producing uniform-modality numpy batches, in the JAX
    package's order for the same seed (its one-process case)."""
    n = len(dataset)
    if group_by_modality:
        order = modality_length_grouped_indices(dataset.modality_lengths, batch_size, 1, seed)
    else:
        order = np.random.default_rng(seed).permutation(n).tolist()
    if dataset._anyres_train:
        # batches uniform in (modality, merge plan): a buffer per key, emitted
        # when it fills; partial buffers drop at the epoch's end
        pending: Dict[Any, List[int]] = {}
        for idx in order:
            k = dataset.batch_key(idx)
            pending.setdefault(k, []).append(idx)
            if len(pending[k]) == batch_size:
                yield collator([dataset[i] for i in pending.pop(k)])
        return
    # group contiguous same-modality indices into batches
    batch: List[int] = []
    for idx in order:
        if batch and dataset.modality_of(idx) != dataset.modality_of(batch[0]):
            if len(batch) == batch_size:
                yield collator([dataset[i] for i in batch])
            batch = []
        batch.append(idx)
        if len(batch) == batch_size:
            yield collator([dataset[i] for i in batch])
            batch = []
