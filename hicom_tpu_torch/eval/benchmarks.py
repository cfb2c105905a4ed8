"""Benchmark definitions: data loading, prompting, answer dumping.

Each benchmark reproduces the reference inference scripts under
``hicom/eval/{video,image}/inference_*.py`` (prompt templates,
guide-instruct choice, answer-file formats) so the reference scorers — and our
ports in ``scorers.py`` — apply unchanged.
"""

from __future__ import annotations

import copy
import json
import os
import re
import traceback
from typing import Callable, Optional

from .common import extract_mcqa_letter, get_chunk, load_questions, open_answer_file, write_jsonl

Infer = Callable[..., str]  # infer(tensor, instruct, modal=..., guide_instruct=...)

REGISTRY = {}


def register(name):
    def deco(cls):
        REGISTRY[name] = cls
        return cls

    return deco


def _find_media(folder: str, stem: str, formats) -> Optional[str]:
    for fmt in formats:
        p = os.path.join(folder, f"{stem}{fmt}")
        if os.path.exists(p):
            return p
    return None


VIDEO_FORMATS = [".mp4", ".avi", ".mov", ".mkv"]
OQA_VIDEO_FORMATS = [".mp4", ".webm", ".avi", ".mov", ".mkv"]  # OQA/caption sets ship .webm


# --------------------------------------------------------------------------- #
# Video-MME
# --------------------------------------------------------------------------- #


def _load_srt(path: str):
    """Minimal .srt parser → [(start_ms, end_ms, text)]."""
    def to_ms(ts: str) -> int:
        h, m, rest = ts.split(":")
        s, ms = rest.replace(".", ",").split(",")
        return ((int(h) * 60 + int(m)) * 60 + int(s)) * 1000 + int(ms)

    entries = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        blocks = f.read().split("\n\n")
    for block in blocks:
        lines = [ln.strip("﻿").strip() for ln in block.strip().splitlines()]
        if len(lines) < 2:
            continue
        tl = next((ln for ln in lines if "-->" in ln), None)
        if tl is None:
            continue
        start, end = [x.strip() for x in tl.split("-->")]
        text = " ".join(lines[lines.index(tl) + 1 :]).replace("\\N", " ")
        text = re.sub(r"<[^>]+>", "", text)
        try:
            entries.append((to_ms(start), to_ms(end), text))
        except ValueError:
            continue
    return entries


def _videomme_load_parquet(path: str) -> list:
    import pyarrow.parquet as pq

    df = pq.read_table(path).to_pandas()
    videos = []
    for rec in df.itertuples():
        q = {
            "question_id": rec.question_id,
            "task_type": rec.task_type,
            "question": rec.question,
            "choices": list(rec.options),
            "answer": rec.answer,
        }
        if len(videos) < int(rec.video_id):
            videos.append({
                "video_id": rec.video_id,
                "youtube_id": rec.videoID,
                "url": rec.url,
                "duration": rec.duration,
                "domain": rec.domain,
                "sub_category": rec.sub_category,
                "questions": [q],
            })
        else:
            videos[-1]["questions"].append(q)
    return videos


@register("videomme")
class VideoMME:
    """Video-MME MCQA, with and without subtitles (two answer files)."""

    def run(self, args, processor, infer: Infer):
        import cv2
        import numpy as np

        videos = _videomme_load_parquet(args.question_file)
        videos = get_chunk(videos, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)
        ans_sub = open_answer_file(args.answer_file.replace(".json", "_sub.json"))

        def prepare(line):
            """Host work off the device's critical path: decode + subtitle align."""
            ytid = line["url"].split("watch?v=")[-1]
            video_path = _find_media(args.video_folder, ytid, VIDEO_FORMATS)
            try:
                tensor = processor["video"](video_path)
                num_frames = tensor.shape[0]
            except Exception:
                traceback.print_exc()
                return line, None, ""
            subtitle = ""
            srt_path = os.path.join(args.subtitle_folder, f"{ytid}.srt") if args.subtitle_folder else None
            if srt_path and os.path.exists(srt_path):
                cap = cv2.VideoCapture(video_path)
                duration = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
                cap.release()
                seg = float(duration - 1) / num_frames
                frame_ids = [int((int(np.round(seg * i)) + int(np.round(seg * (i + 1)))) // 2) for i in range(num_frames)]
                subs = _load_srt(srt_path)
                texts = []
                for fid in frame_ids:
                    t_ms = int(fid / fps * 1000)
                    for s_ms, e_ms, text in subs:
                        if s_ms < t_ms < e_ms:
                            if text.strip():
                                texts.append(text)
                            break
                subtitle = "\n".join(texts)
            return line, tensor, subtitle

        for line, tensor, subtitle in _prefetched(videos, prepare):
            rec, rec_sub = copy.deepcopy(line), copy.deepcopy(line)
            if tensor is None:
                rec["missing"] = rec_sub["missing"] = True
                write_jsonl(ans, rec, trailing_comma=True)
                write_jsonl(ans_sub, rec_sub, trailing_comma=True)
                continue
            rec["missing"] = rec_sub["missing"] = False

            for idx, question in enumerate(line["questions"]):
                q = question["question"]
                choices = question["choices"]
                options = [re.findall(r"[A-D]\. (.*).", c)[0] for c in choices]
                instruct = (
                    "Select the best answer to the following multiple-choice question based on the video. "
                    "Respond with only the letter (A, B, C, or D) of the correct option.\n"
                    + f"{q}\n" + "".join(f"{c}\n" for c in choices)
                    + "Answer with the option's letter from the given choices directly and only give the best option. The best answer is: "
                )
                out = infer(tensor, instruct, modal="video", guide_instruct=q)
                rec["questions"][idx]["response"] = "ABCD"[
                    extract_mcqa_letter(out, "ABCD", options, match_digit_words=True)
                ]
                out_sub = infer(
                    tensor, f"This video's subtitles are listed below:\n{subtitle}\n" + instruct,
                    modal="video", guide_instruct=q,
                )
                rec_sub["questions"][idx]["response"] = "ABCD"[
                    extract_mcqa_letter(out_sub, "ABCD", options, match_digit_words=True)
                ]
            write_jsonl(ans, rec, trailing_comma=True)
            write_jsonl(ans_sub, rec_sub, trailing_comma=True)
        ans.close()
        ans_sub.close()


# --------------------------------------------------------------------------- #
# MVBench / MLVU (letterized MCQA over task-json collections)
# --------------------------------------------------------------------------- #

MVBENCH_TASKS = {
    "Action Sequence": ("action_sequence.json", "star/Charades_v1_480/", "video", True),
    "Action Prediction": ("action_prediction.json", "star/Charades_v1_480/", "video", True),
    "Action Antonym": ("action_antonym.json", "ssv2_video/", "video", False),
    "Fine-grained Action": ("fine_grained_action.json", "Moments_in_Time_Raw/videos/", "video", False),
    "Unexpected Action": ("unexpected_action.json", "FunQA_test/test/", "video", False),
    "Object Existence": ("object_existence.json", "clevrer/video_validation/", "video", False),
    "Object Interaction": ("object_interaction.json", "star/Charades_v1_480/", "video", True),
    "Object Shuffle": ("object_shuffle.json", "perception/videos/", "video", False),
    "Moving Direction": ("moving_direction.json", "clevrer/video_validation/", "video", False),
    "Action Localization": ("action_localization.json", "sta/sta_video/", "video", True),
    "Scene Transition": ("scene_transition.json", "scene_qa/video/", "video", False),
    "Action Count": ("action_count.json", "perception/videos/", "video", False),
    "Moving Count": ("moving_count.json", "clevrer/video_validation/", "video", False),
    "Moving Attribute": ("moving_attribute.json", "clevrer/video_validation/", "video", False),
    "State Change": ("state_change.json", "perception/videos/", "video", False),
    "Fine-grained Pose": ("fine_grained_pose.json", "nturgbd/", "video", False),
    "Character Order": ("character_order.json", "perception/videos/", "video", False),
    "Egocentric Navigation": ("egocentric_navigation.json", "vlnqa/", "video", False),
    "Episodic Reasoning": ("episodic_reasoning.json", "tvqa/frames_fps3_hq/", "frame", True),
    "Counterfactual Inference": ("counterfactual_inference.json", "clevrer/video_validation/", "video", False),
}

MLVU_TASKS = {
    "count": ("4_count.json", "4_count", "video"),
    "ego": ("3_ego.json", "3_ego", "video"),
    "needle": ("2_needle.json", "2_needle", "video"),
    "order": ("5_order.json", "5_order", "video"),
    "plotQA": ("1_plotQA.json", "1_plotQA", "video"),
    "anomaly_reco": ("6_anomaly_reco.json", "6_anomaly_reco", "video"),
    "topic_reasoning": ("7_topic_reasoning.json", "7_topic_reasoning", "video"),
}


def _prefetched(items, prepare, workers: Optional[int] = None):
    """Bounded multi-worker prefetch: decode upcoming videos on worker threads
    while the device runs the current sample (the reference leans on 8 torch
    DataLoader workers, ``inference_video_mcqa_videomme.py:325-326``; SURVEY §7
    flags host decode as the bottleneck). The native libav reader and the C++
    preprocessor release the GIL, so threads scale with host cores.

    ``HICOM_PREFETCH_WORKERS`` overrides; the default is one worker per host
    core (capped at 8) — on a 1-core host that degrades to one clip decoded
    ahead. In-flight decodes are bounded at workers+1 so memory
    stays ~(workers+1) decoded clips regardless of dataset size, and results
    yield strictly in submission order."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    items = list(items)
    if not items:
        return
    if workers is None:
        workers = int(os.environ.get("HICOM_PREFETCH_WORKERS", "0")) or min(
            8, os.cpu_count() or 1)
    depth = workers + 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = deque(pool.submit(prepare, it) for it in items[:depth])
        nxt = depth
        while futs:
            cur = futs.popleft().result()
            if nxt < len(items):
                futs.append(pool.submit(prepare, items[nxt]))
                nxt += 1
            yield cur


def run_mcqa(items, prepare, record, infer, infer_batch=None, batch_size: int = 1):
    """Drive MCQA samples singly or in same-shape batches (one compiled
    prefill+decode per batch, in place of the reference's per-GPU fan-out)."""
    if infer_batch is None or batch_size <= 1:
        for prep in _prefetched(items, prepare):
            out = infer(prep[0], prep[1], modal="video", guide_instruct=prep[2]["question"])
            record(out, prep)
        return
    pending = []
    def flush():
        if not pending:
            return
        # pad ragged batches to batch_size (repeat the last sample, discard
        # its extra outputs): one compiled shape, data-parallel divisibility
        n = len(pending)
        batch = pending + [pending[-1]] * (batch_size - n)
        outs = infer_batch(
            [p[0] for p in batch], [p[1] for p in batch],
            [p[2]["question"] for p in batch],
        )
        for out, prep in zip(outs[:n], pending):
            record(out, prep)
        pending.clear()

    for prep in _prefetched(items, prepare):
        if pending and prep[0].shape != pending[0][0].shape:
            flush()
        pending.append(prep)
        if len(pending) == batch_size:
            flush()
    flush()


def _letterize(options):
    letters, options_string = [], ""
    for i, c in enumerate(options):
        letters.append(chr(ord("A") + i))
        options_string += f"({chr(ord('A') + i)}) {c}\n"
    return letters, options_string


@register("mvbench")
class MVBench:
    def run(self, args, processor, infer: Infer):
        data_list = []
        for task_name, (json_file, folder, data_type, has_bound) in MVBENCH_TASKS.items():
            with open(os.path.join(args.question_file, json_file)) as f:
                for data in json.load(f):
                    data_list.append(dict(task_type=task_name, prefix=os.path.join(args.video_folder, folder),
                                          data_type=data_type, bound=has_bound, data=data))
        data_list = get_chunk(data_list, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)

        def prepare(item):
            d = item["data"]
            s, e = (d["start"], d["end"]) if item["bound"] else (None, None)
            video_path = os.path.join(item["prefix"], d["video"])
            tensor = processor["video"](video_path, s=s, e=e)
            letters, options_string = _letterize(d["candidates"])
            answer_idx = d["candidates"].index(d["answer"]) if d["answer"] in d["candidates"] else -1
            instruct = (
                f"Question: {d['question']}\nOptions:\n{options_string}"
                "Answer with the option's letter from the given choices directly and only give the best option."
            )
            return tensor, instruct, d, letters, video_path, answer_idx, item["task_type"]

        def record(out, prep):
            _, instruct, d, letters, video_path, answer_idx, task_type = prep
            pred_idx = extract_mcqa_letter(out, letters, d["candidates"])
            write_jsonl(ans, {"vid": video_path, "task_type": task_type, "pred": pred_idx, "gt": answer_idx})

        run_mcqa(data_list, prepare, record, infer, getattr(args, "infer_batch", None),
                 getattr(args, "batch_size", 1))
        ans.close()


@register("mlvu")
class MLVU:
    def run(self, args, processor, infer: Infer):
        import random

        data_list = []
        for task_name, (json_file, folder, _) in MLVU_TASKS.items():
            with open(os.path.join(args.question_file, json_file)) as f:
                for data in json.load(f):
                    data_list.append(dict(task_type=task_name, prefix=os.path.join(args.video_folder, folder), data=data))
        random.seed(0)
        random.shuffle(data_list)  # deterministic shuffle (reference :122)
        data_list = get_chunk(data_list, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)

        def prepare(item):
            d = item["data"]
            video_path = os.path.join(item["prefix"], d["video"])
            tensor = processor["video"](video_path)
            letters, options_string = _letterize(d["candidates"])
            answer_idx = d["candidates"].index(d["answer"]) if d["answer"] in d["candidates"] else -1
            instruct = (
                f"Question: {d['question']}\nOptions: \n{options_string}\n"
                "Answer with the option's letter from the given choices directly and only give the best option."
            )
            return tensor, instruct, d, letters, video_path, answer_idx, item["task_type"]

        def record(out, prep):
            _, instruct, d, letters, video_path, answer_idx, task_type = prep
            pred_idx = extract_mcqa_letter(out, letters, d["candidates"])
            write_jsonl(ans, {"vid": video_path, "question": instruct, "task_type": task_type,
                              "pred": pred_idx, "gt": answer_idx})

        run_mcqa(data_list, prepare, record, infer, getattr(args, "infer_batch", None),
                 getattr(args, "batch_size", 1))
        ans.close()


@register("egoschema")
class EgoSchema:
    def run(self, args, processor, infer: Infer):
        questions = load_questions(args.question_file)
        questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)
        def prepare(line):
            video_path = _find_media(args.video_folder, line["q_uid"], VIDEO_FORMATS)
            if video_path is None:
                raise FileNotFoundError(f"video not found: {line['q_uid']}")
            return line, processor["video"](video_path)

        for line, tensor in _prefetched(questions, prepare):
            q_uid = line["q_uid"]
            opts = [line[f"option {i}"] for i in range(5)]
            instruct = (
                "Select the best answer to the following multiple-choice question based on the video.\n"
                f"{line['question']}\nOptions:\n"
                + "".join(f"({l}) {o}\n" for l, o in zip("ABCDE", opts))
                + "Answer with the option's letter from the given choices directly and only give the best option. The best answer is: "
            )
            out = infer(tensor, instruct, modal="video", guide_instruct=line["question"])
            out = out.replace("answer", "").replace("Answer", "")
            found = re.findall(r"[\(\ ]*[A-E][\)\ ]*", out)
            try:
                pred_idx = "ABCDE".index(found[0].strip().strip("()"))
            except (IndexError, ValueError):
                pred_idx = 2
            ans.write(f"{q_uid}, {pred_idx}\n")
        ans.close()


# --------------------------------------------------------------------------- #
# Open-ended video QA (ActivityNet / MSVD / MSRVTT) and Video-ChatGPT
# --------------------------------------------------------------------------- #


@register("activitynet_oqa")
class ActivityNetOQA:
    """Open-ended QA; results judged later by the GPT scorer."""

    formats = OQA_VIDEO_FORMATS

    def run(self, args, processor, infer: Infer):
        questions = load_questions(args.question_file)
        answers = load_questions(args.answer_gt_file) if args.answer_gt_file else [{}] * len(questions)
        pairs = get_chunk(list(zip(questions, answers)), args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)

        def prepare(pair):
            sample, answer = pair
            name = sample["video_name"]
            video_path = _find_media(args.video_folder, f"v_{name}", self.formats) or _find_media(
                args.video_folder, name, self.formats
            )
            if video_path is None:
                raise FileNotFoundError(f"video not found: {name}")
            return sample, answer, processor["video"](video_path)

        for sample, answer, tensor in _prefetched(pairs, prepare):
            name = sample["video_name"]
            q = sample["question"]
            out = infer(tensor, q, modal="video", guide_instruct=q)
            write_jsonl(ans, {
                "video_name": name, "question": q, "question_id": sample.get("question_id"),
                "answer": answer.get("answer"), "pred": out,
            })
        ans.close()


@register("vcgpt_general")
class VCGPTGeneral(ActivityNetOQA):
    """Video-ChatGPT generic OQA (correctness/detail/context/temporal axes)."""


@register("vcgpt_consistency")
class VCGPTConsistency:
    formats = OQA_VIDEO_FORMATS

    def run(self, args, processor, infer: Infer):
        questions = load_questions(args.question_file)
        questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)

        def prepare(sample):
            name = sample["video_name"]
            video_path = _find_media(args.video_folder, f"v_{name}", self.formats) or _find_media(
                args.video_folder, name, self.formats
            )
            if video_path is None:
                raise FileNotFoundError(f"video not found: {name}")
            return sample, processor["video"](video_path)

        for sample, tensor in _prefetched(questions, prepare):
            name = sample["video_name"]
            q1, q2 = sample["Q1"], sample["Q2"]
            p1 = infer(tensor, q1, modal="video", guide_instruct=q1)
            p2 = infer(tensor, q2, modal="video", guide_instruct=q2)
            write_jsonl(ans, {"video_name": name, "Q1": q1, "Q2": q2, "A": sample["A"], "P1": p1, "P2": p2})
        ans.close()


@register("msvc")
class MSVCCaption:
    """MSVC multi-reference video captioning: generate one caption per video;
    the GPT judge scores correctness/detailedness vs the reference captions."""

    formats = OQA_VIDEO_FORMATS

    def run(self, args, processor, infer: Infer):
        questions = load_questions(args.question_file)
        questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)

        def prepare(sample):
            if "video_path" in sample:
                name = os.path.splitext(os.path.basename(sample["video_path"]))[0]
                video_path = sample["video_path"]
                # only a sample-provided relative path needs the folder prefix
                # (_find_media results are already joined)
                if args.video_folder and not os.path.isabs(video_path):
                    video_path = os.path.join(args.video_folder, video_path)
            else:
                name = sample["video_name"]
                video_path = _find_media(args.video_folder, name, self.formats)
                if video_path is None:
                    raise FileNotFoundError(f"video not found: {name}")
            return sample, name, processor["video"](video_path)

        for sample, name, tensor in _prefetched(questions, prepare):
            q = sample.get("question", "Please describe the video in detail.")
            out = infer(tensor, q, modal="video", guide_instruct=q)
            write_jsonl(ans, {"video_name": name, "question": q,
                              "answer": sample.get("captions", sample.get("answer")), "pred": out})
        ans.close()


# --------------------------------------------------------------------------- #
# Image VQA (gqa / pope / vqav2 / vizwiz / MME / textvqa / ...)
# --------------------------------------------------------------------------- #


def get_guide_instruct(question: str, benchmark: str) -> Optional[str]:
    """Per-benchmark guide prompt strip rules (reference inference_image_vqa.py:129-137)."""
    if benchmark in ("gqa", "MME", "pope", "vqav2"):
        return question.replace("\nAnswer the question using a single word or phrase.", "")
    if benchmark in ("scienceqa", "seed_bench"):
        return question.split("\nA. ")[0]
    if benchmark in ("textvqa",):
        return question.split("\nReference OCR token:")[0]
    if benchmark in ("vizwiz",):
        return question.replace(
            "\nWhen the provided information is insufficient, respond with 'Unanswerable'.\nAnswer the question using a single word or phrase.",
            "",
        )
    return question


@register("image_vqa")
class ImageVQA:
    def run(self, args, processor, infer: Infer):
        import uuid

        questions = load_questions(args.question_file)
        questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
        ans = open_answer_file(args.answer_file)
        for line in questions:
            image_path = os.path.join(args.image_folder, line["image"])
            tensor, sizes = processor["image"](image_path)
            q = line["text"]
            out = infer(tensor, q, modal="image", image_size=sizes[0],
                        guide_instruct=get_guide_instruct(q, args.sub_benchmark))
            write_jsonl(ans, {
                "question_id": line["question_id"], "prompt": q, "text": out,
                "answer_id": uuid.uuid4().hex[:22], "model_id": args.model_id, "metadata": {},
            })
        ans.close()
