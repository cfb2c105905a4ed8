"""Prompt tokenization around a modal tag (a copy of ``hicom_tpu/data/prompts.py``'s).

The tag's negative sentinel id is spliced between the tokenized text chunks.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, MODAL_INDEX_MAP


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
