"""Shared eval utilities: chunking, MCQA answer extraction, IO."""

from __future__ import annotations

import json
import math
import os
import re
from typing import List, Optional, Sequence

DIGIT2WORD = {
    "1": "one", "2": "two", "3": "three", "4": "four", "5": "five",
    "6": "six", "7": "seven", "8": "eight", "9": "nine", "0": "zero",
}


def get_chunk(lst: list, num_chunks: int, chunk_idx: int) -> list:
    """Reference chunking (eval scripts): ceil-sized contiguous blocks."""
    chunk_size = math.ceil(len(lst) / num_chunks)
    chunks = [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]
    return chunks[chunk_idx] if chunk_idx < len(chunks) else []


def extract_mcqa_letter(
    output: str,
    letters: Sequence[str],
    options: Optional[Sequence[str]] = None,
    match_digit_words: bool = False,
    default_idx: int = 2,
) -> int:
    """Extract the chosen option index from a model response.

    Reference behavior (``videomme_dump`` / ``mvbench_dump``): strip
    'answer'/'Answer', regex a letter in brackets/spaces, else substring-match
    option text (optionally digit→word), else default to index 2 ('C').
    """
    output = output.replace("answer", "").replace("Answer", "")
    pattern = rf"[\(,\ \[]*([{letters[0]}-{letters[-1]}])[\),\.\ \]]*"
    found = re.findall(pattern, output)
    if found:
        letter = found[0].strip().strip("()")
        if letter in letters:
            return list(letters).index(letter)
    if options:
        for idx, opt in enumerate(options):
            opt2 = DIGIT2WORD.get(opt, opt) if match_digit_words else opt
            if opt.lower() in output.lower() or opt2.lower() in output.lower():
                return idx
    return default_idx


def open_answer_file(path: str):
    """``path`` opened for writing, its directory made; on a rank other than 0
    of a process group (``--data-parallel``), a sink: only rank 0 writes."""
    from ..utils import is_main_process

    if not is_main_process():
        return open(os.devnull, "w")
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, "w")


def load_questions(path: str) -> list:
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def write_jsonl(f, obj, trailing_comma: bool = False):
    f.write(json.dumps(obj) + (",\n" if trailing_comma else "\n"))
    f.flush()


def merge_chunked_videomme(chunk_files: List[str]) -> list:
    """Reference merge (eval_video_mcqa_videomme.sh:42-67): concatenated
    ',\n'-terminated records wrapped into a JSON list."""
    records = []
    for path in chunk_files:
        with open(path) as f:
            content = f.read().strip().rstrip(",")
        if content:
            records.extend(json.loads(f"[{content}]"))
    return records
