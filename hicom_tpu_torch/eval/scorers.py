"""Benchmark scorers (pure python; no model needed).

Reproduces the reference scorers' metrics so results are comparable:
Video-MME per-duration/domain/task accuracy, MVBench/MLVU accuracy tables,
EgoSchema CSV, POPE F1, EvalAI-standard VQA accuracy (3-of-10), plus the
submission-format converters for GQA/VQAv2/VizWiz.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional

from .benchmarks import MLVU_TASKS, MVBENCH_TASKS

# --------------------------------------------------------------------------- #
# Video-MME
# --------------------------------------------------------------------------- #

VIDEOMME_CATEGORIES = [
    "Knowledge", "Film & Television", "Sports Competition",
    "Artistic Performance", "Life Record", "Multilingual",
]
VIDEOMME_TASKS = [
    "Temporal Perception", "Spatial Perception", "Attribute Perception",
    "Action Recognition", "Object Recognition", "OCR Problems",
    "Counting Problem", "Temporal Reasoning", "Spatial Reasoning",
    "Action Reasoning", "Object Reasoning", "Information Synopsis",
]


def videomme_extract_letter(s: str) -> str:
    """Reference ``extract_characters_regex``: strip answer prefixes, find a
    single A-D; long answers with no letter count as unanswered."""
    s = s.strip()
    for prefix in [
        "The best answer is", "The correct answer is", "The answer is",
        "The answer", "The best option is" "The correct option is",
        "Best answer:" "Best option:",
    ]:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    m = re.search(r"[ABCD]", s)
    return m[0] if m else ""


def score_videomme(
    results: List[dict],
    video_types=("short", "medium", "long"),
    skip_missing: bool = True,
) -> Dict:
    """Returns nested accuracy dict {duration: {overall, by_domain, by_task}}."""
    out = {}
    totals = {"correct": 0, "answered": 0}
    for vtype in video_types:
        stats = {
            "by_task": defaultdict(lambda: {"correct": 0, "answered": 0}),
            "by_domain": defaultdict(lambda: {"correct": 0, "answered": 0}),
            "by_sub_category": defaultdict(lambda: {"correct": 0, "answered": 0}),
        }
        for item in (r for r in results if r["duration"] == vtype):
            if skip_missing and item.get("missing"):
                continue
            for q in item["questions"]:
                letter = videomme_extract_letter(q["response"])
                if letter == "":
                    continue
                correct = int(letter == q["answer"])
                for key, name in (
                    ("by_task", q["task_type"]),
                    ("by_domain", item["domain"]),
                    ("by_sub_category", item["sub_category"]),
                ):
                    stats[key][name]["answered"] += 1
                    stats[key][name]["correct"] += correct
        answered = sum(v["answered"] for v in stats["by_task"].values())
        correct = sum(v["correct"] for v in stats["by_task"].values())
        totals["answered"] += answered
        totals["correct"] += correct
        out[vtype] = {
            "overall": 100 * correct / answered if answered else 0.0,
            "answered": answered,
            **{k: {n: 100 * v["correct"] / v["answered"] if v["answered"] else 0.0 for n, v in stats[k].items()}
               for k in ("by_task", "by_domain", "by_sub_category")},
        }
    out["overall"] = 100 * totals["correct"] / totals["answered"] if totals["answered"] else 0.0
    out["answered"] = totals["answered"]
    return out


# --------------------------------------------------------------------------- #
# MVBench / MLVU: jsonl of {"task_type", "pred", "gt"}
# --------------------------------------------------------------------------- #


def score_mcqa_jsonl(path: str, task_names: Optional[List[str]] = None) -> Dict:
    rows = [json.loads(line) for line in open(path) if line.strip()]
    per_task = defaultdict(list)
    overall = []
    for r in rows:
        v = int(r["pred"] == r["gt"])
        overall.append(v)
        per_task[r["task_type"]].append(v)
    task_names = task_names or sorted(per_task)
    return {
        "overall": 100 * sum(overall) / len(overall) if overall else 0.0,
        "by_task": {t: 100 * sum(per_task[t]) / len(per_task[t]) if per_task[t] else 0.0 for t in task_names},
        "count": len(overall),
    }


def score_mvbench(path: str) -> Dict:
    return score_mcqa_jsonl(path, list(MVBENCH_TASKS))


def score_mlvu(path: str) -> Dict:
    return score_mcqa_jsonl(path, list(MLVU_TASKS))


def score_egoschema_csv(path: str, answers_json: Optional[str] = None) -> Dict:
    """Local accuracy against an answer map (the reference POSTs to a remote
    validation server, eval_video_maqa_egoschema.py:25-45 — gated offline)."""
    preds = {}
    for line in open(path):
        if not line.strip():
            continue
        q_uid, idx = [x.strip() for x in line.split(",")]
        preds[q_uid] = int(idx)
    if answers_json is None:
        return {"count": len(preds)}
    answers = json.load(open(answers_json))
    correct = sum(int(preds.get(k) == v) for k, v in answers.items() if k in preds)
    graded = sum(1 for k in answers if k in preds)
    return {"overall": 100 * correct / graded if graded else 0.0, "count": graded}


# --------------------------------------------------------------------------- #
# POPE
# --------------------------------------------------------------------------- #


def _pope_binarize(text: str) -> int:
    if text.find(".") != -1:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return 0 if ("No" in words or "not" in words or "no" in words) else 1


def score_pope(answers: List[dict], label_file: str) -> Dict:
    labels = [1 if json.loads(line)["label"] != "no" else 0 for line in open(label_file)]
    preds = [_pope_binarize(a["text"]) for a in answers]
    TP = sum(1 for p, l in zip(preds, labels) if p == 1 and l == 1)
    FP = sum(1 for p, l in zip(preds, labels) if p == 1 and l == 0)
    TN = sum(1 for p, l in zip(preds, labels) if p == 0 and l == 0)
    FN = sum(1 for p, l in zip(preds, labels) if p == 0 and l == 1)
    precision = TP / (TP + FP) if TP + FP else 0.0
    recall = TP / (TP + FN) if TP + FN else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    graded = TP + TN + FP + FN  # reference eval_pope.py:52 denominator
    assert graded == len(preds) == len(labels), (
        f"preds/labels mismatch: {len(preds)} answers vs {len(labels)} labels"
    )
    return {
        "TP": TP, "FP": FP, "TN": TN, "FN": FN,
        "accuracy": (TP + TN) / max(graded, 1),
        "precision": precision, "recall": recall, "f1": f1,
        "yes_ratio": preds.count(1) / max(len(preds), 1),
    }


def score_pope_all(question_file: str, result_file: str, annotation_dir: str) -> Dict:
    questions = {json.loads(line)["question_id"]: json.loads(line) for line in open(question_file)}
    answers = [json.loads(line) for line in open(result_file)]
    out = {}
    for fname in os.listdir(annotation_dir):
        assert fname.startswith("coco_pope_") and fname.endswith(".json")
        category = fname[10:-5]
        cur = [a for a in answers if questions[a["question_id"]]["category"] == category]
        out[category] = score_pope(cur, os.path.join(annotation_dir, fname))
    return out


# --------------------------------------------------------------------------- #
# EvalAI-standard VQA accuracy (VQAv2 / VizWiz / TextVQA)
# --------------------------------------------------------------------------- #

# Standard EvalAI normalization tables (VQA metric definition).
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't", "notve": "not've",
    "oclock": "o'clock", "oughtnt": "oughtn't", "ow's'at": "'ow's'at",
    "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at", "shant": "shan't",
    "shed've": "she'd've", "she'dve": "she'd've", "she's": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've", "yall": "y'all",
    "yall'll": "y'all'll", "y'allll": "y'all'll", "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've", "youd": "you'd",
    "youd've": "you'd've", "you'dve": "you'd've", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}
_ARTICLES = ["a", "an", "the"]
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCTUATION = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


class EvalAIAnswerProcessor:
    """Standard EvalAI VQA answer normalization."""

    def word_tokenize(self, word):
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, text):
        out = text
        for p in _PUNCTUATION:
            if (p + " " in text or " " + p in text) or (re.search(_COMMA_STRIP, text) is not None):
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        out = _PERIOD_STRIP.sub("", out, re.UNICODE)
        return out

    def process_digit_article(self, text):
        temp = []
        for word in text.lower().split():
            word = _NUMBER_MAP.get(word, word)
            if word not in _ARTICLES:
                temp.append(word)
        for i, word in enumerate(temp):
            if word in _CONTRACTIONS:
                temp[i] = _CONTRACTIONS[word]
        return " ".join(temp)

    def __call__(self, item):
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """VQA-style 3-of-10 accuracy."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self, raw_answers):
        answers = [self.answer_processor(a) for a in raw_answers]
        assert len(answers) == 10
        gt_answers = list(enumerate(answers))
        unique_answers = set(answers)
        unique_answer_scores = {}
        for unique_answer in unique_answers:
            accs = []
            for gt_answer in gt_answers:
                other_answers = [item for item in gt_answers if item != gt_answer]
                matching = [item for item in other_answers if item[1] == unique_answer]
                accs.append(min(1, float(len(matching)) / 3))
            unique_answer_scores[unique_answer] = sum(accs) / len(accs)
        return unique_answer_scores

    def eval_pred_list(self, pred_list):
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            unique_answer_scores = self._compute_answer_scores(entry["gt_answers"])
            pred_scores.append(unique_answer_scores.get(pred_answer, 0.0))
        return sum(pred_scores) / max(len(pred_scores), 1)


class STVQAAccuracyEvaluator:
    """Exact-match accuracy after EvalAI normalization."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list):
        scores = []
        for entry in pred_list:
            pred = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            scores.append(1.0 if pred in gts else 0.0)
        return sum(scores) / max(len(scores), 1)


# --------------------------------------------------------------------------- #
# Submission converters (GQA / VQAv2 / VizWiz)
# --------------------------------------------------------------------------- #


def convert_gqa_for_eval(src_jsonl: str, dst_json: str) -> None:
    out = []
    for line in open(src_jsonl):
        row = json.loads(line)
        out.append({"questionId": row["question_id"], "prediction": row["text"].rstrip(".").lower()})
    json.dump(out, open(dst_json, "w"))


def convert_vqav2_for_submission(result_jsonl: str, test_split_jsonl: str, dst_json: str) -> None:
    processor = EvalAIAnswerProcessor()
    results = {json.loads(line)["question_id"]: json.loads(line)["text"] for line in open(result_jsonl)}
    out = []
    for line in open(test_split_jsonl):
        q = json.loads(line)
        out.append({"question_id": q["question_id"], "answer": processor(results.get(q["question_id"], ""))})
    json.dump(out, open(dst_json, "w"))


def convert_vizwiz_for_submission(result_jsonl: str, annotation_json: str, dst_json: str) -> None:
    """Reference convert_vizwiz_for_submission.py: jsonl test split keyed by
    question_id; every split question must have an answer (assert, not '')."""
    processor = EvalAIAnswerProcessor()
    results = {json.loads(line)["question_id"]: json.loads(line)["text"] for line in open(result_jsonl)}
    test_split = [json.loads(line) for line in open(annotation_json) if line.strip()]
    out = []
    for x in test_split:
        assert x["question_id"] in results, f"missing answer for question {x['question_id']}"
        out.append({"image": x["image"], "answer": processor(results[x["question_id"]])})
    json.dump(out, open(dst_json, "w"))
