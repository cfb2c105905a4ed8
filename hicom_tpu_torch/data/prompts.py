"""Prompt and tokenization helpers (a copy of ``hicom_tpu/data/prompts.py``'s).

Sentinel splicing around a modal tag, and the guide-prompt extraction the
guide encoder reads (reference ``mm_utils.py:21-51,647-682``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, MODAL_INDEX_MAP

OPTION_PROMPT_LIST = [
    "Select one or more correct answers from following:\n",
    "Choose the corresponding category that captures this action from the offered options. Options:\n",
    "Pick the most suitable category that represents the interaction from the provided options. Options:\n",
    "Select the most accurate category from the available choices. Options:\n",
    "Identify the most accurate action category from the provided options. Options:\n",
    "Choose the appropriate action category from the listed choices. Options:\n",
    "Determine the action category that aligns best with these features from the selection provided. Options:\n",
    "Select the category that best characterizes this interaction from the given choices. Options:\n",
    "Pick the relevant category from the list of options. Options:\n",
    "Select the fitting category that describes their interaction from the available options. Options:\n",
    "Determine the best-matching action category from the choices given. Options:\n",
    "\nOptions:\nA. ",
]


def extract_guided_prompt(prompt: str) -> str:
    """Strip modal tags and option lists, keeping the bare question for the
    guide text encoder (reference mm_utils.py:36-51)."""
    guided = prompt.replace("<image>", "").replace("<video>", "").strip()
    guided = guided.replace("Answer the question using a single word or phrase.", "")
    if (
        "Please provide your answer by stating the letter followed by the full option." in guided
        or "Please respond with only the letter of the correct answer." in guided
    ):
        guided = guided.split("\nA. ")[0]
    elif guided.startswith("Question: "):
        guided = guided.lstrip("Question: ")
        guided = guided.split("\nOptions:\n(A)")[0]
    else:
        for option_prompt in OPTION_PROMPT_LIST:
            if option_prompt in guided:
                guided = guided.split(option_prompt)[0]
                break
        if "Options:\n(A)" in guided:
            guided = guided.split("Options:\n(A)")[0].split("Question: ")[-1]
    return guided


def tokenizer_multimodal_token(
    prompt: str,
    tokenizer,
    multimodal_token: str = DEFAULT_IMAGE_TOKEN,
    return_tensors: Optional[str] = None,
) -> Union[List[int], np.ndarray]:
    """Tokenize text around a modal tag, splicing its sentinel index between
    the chunks (reference ``mm_utils.py:647-672``)."""
    sentinel = MODAL_INDEX_MAP.get(multimodal_token)
    if sentinel is None:
        input_ids = tokenizer(prompt, add_special_tokens=False).input_ids
    else:
        chunks = [tokenizer(c, add_special_tokens=False).input_ids for c in prompt.split(multimodal_token)]
        input_ids = []
        for i, chunk in enumerate(chunks):
            if i > 0:
                input_ids.append(sentinel)
            input_ids.extend(chunk)
    if return_tensors == "np":
        return np.asarray(input_ids, dtype=np.int64)
    if return_tensors is not None:
        raise ValueError(f"unsupported tensor type: {return_tensors}")
    return input_ids


def get_model_name_from_path(model_path: str) -> str:
    parts = model_path.strip("/").split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


def convert_guide_format(sample: dict):
    """Split a multi-turn conversation into per-answer samples for guide-mode
    training (reference mm_utils.py:54-81). Returns list of samples or False."""
    if "image" not in sample and "video" not in sample:
        return [sample]
    conversations = sample["conversations"]
    if len(conversations) % 2 != 0:
        return False
    if "image" in sample and "<image>" not in conversations[0]["value"]:
        conversations[0]["value"] = "<image>\n" + conversations[0]["value"]
    if "video" in sample and "<video>" not in conversations[0]["value"]:
        if "<image>" in conversations[0]["value"]:
            conversations[0]["value"] = conversations[0]["value"].replace("<image>", "<video>")
        else:
            conversations[0]["value"] = "<video>\n" + conversations[0]["value"]
    out = []
    for i in range(1, len(conversations), 2):
        assert conversations[i - 1]["from"] == "human"
        assert conversations[i]["from"] == "gpt"
        new_sample = dict(sample)
        new_sample["conversations"] = conversations[: i + 1]
        out.append(new_sample)
    return out
