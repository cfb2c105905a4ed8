"""GPT-judged open-ended QA scoring (ActivityNet/MSVD/MSRVTT OQA, the five
Video-ChatGPT axes, MSVC captioning).

Structure mirrors the reference judges (``eval_video_oqa_activitynet.py``,
``eval_video_oqa_vcgpt_{1..5}*.py``, ``eval_video_cap_msvc_*.py``): per-sample
judgments cached as JSON files in ``output_dir`` (incremental resume),
thread-pool fan-out, then aggregate accuracy + mean score. Requires the
``openai`` package and Azure credentials (AZURE_OPENAI_ENDPOINT /
AZURE_OPENAI_KEY / AZURE_OPENAI_DEPLOYNAME); unavailable offline → clean error.

The RUBRICS below are the reference's prompt text VERBATIM (GPT-judged scores
are prompt-sensitive, so the prompts are part of the metric's definition —
same class as the m4c answer-normalization tables). Sources:
``eval_video_oqa_vcgpt_1_correctness.py:50-76`` and siblings,
``eval_video_oqa_activitynet.py:38-63``, ``eval_video_cap_msvc_*.py:52-77``.
Parity is asserted by ``tests/test_eval.py::test_gpt_judge_rubrics_verbatim``
via AST extraction from the reference source (tests/judge_prompt_extract.py) —
including the reference's literal quirks (the ``{''score': 4.8}`` example
typo, the stray space in the consistency system prompt, the double space in
the ActivityNet user prompt). Completion parameters match
``eval_video_oqa_vcgpt_1_correctness.py:22-32``: temperature=0.7,
max_tokens=800, top_p=0.95, zero penalties, api_version 2024-02-15-preview.

Placeholders ``{question}``/``{answer}``/``{pred}`` (and the ``1``/``2``
variants for the consistency axis) are substituted with str.replace — NOT
str.format, because the verbatim prompts contain literal braces in the
example dict strings.
"""

from __future__ import annotations

import ast
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

RUBRICS = {
    # Video-ChatGPT axis 1 (eval_video_oqa_vcgpt_1_correctness.py:54-72)
    'correctness': {'system': 'You are an intelligent chatbot designed for evaluating the factual '
                              'accuracy of generative outputs for video-based question-answer pairs. '
                              'Your task is to compare the predicted answer with the correct answer '
                              "and determine if they are factually consistent. Here's how you can "
                              'accomplish the task:------##INSTRUCTIONS: - Focus on the factual '
                              'consistency between the predicted answer and the correct answer. The '
                              'predicted answer should not contain any misinterpretations or '
                              'misinformation.\n'
                              '- The predicted answer must be factually accurate and align with the '
                              'video content.\n'
                              '- Consider synonyms or paraphrases as valid matches.\n'
                              '- Evaluate the factual accuracy of the prediction compared to the '
                              'answer.',
                    'user': 'Please evaluate the following video-based question-answer pair:\n'
                            '\n'
                            'Question: {question}\n'
                            'Correct Answer: {answer}\n'
                            'Predicted Answer: {pred}\n'
                            '\n'
                            'Provide your evaluation only as a factual accuracy score where the '
                            'factual accuracy score is an integer value between 0 and 5, with 5 '
                            'indicating the highest level of factual consistency. Please generate the '
                            "response in the form of a Python dictionary string with keys 'score', "
                            'where its value is the factual accuracy score in INTEGER, not STRING.DO '
                            'NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the '
                            'Python dictionary string. For example, your response should look like '
                            "this: {''score': 4.8}."},
    # Video-ChatGPT axis 2 (eval_video_oqa_vcgpt_2_detailed_orientation.py:53-72)
    'detailed_orientation': {'system': 'You are an intelligent chatbot designed for evaluating the '
                                       'detail orientation of generative outputs for video-based '
                                       'question-answer pairs. Your task is to compare the predicted '
                                       'answer with the correct answer and determine its level of '
                                       "detail, considering both completeness and specificity. Here's "
                                       'how you can accomplish the task:------##INSTRUCTIONS: - Check '
                                       'if the predicted answer covers all major points from the '
                                       'video. The response should not leave out any key aspects.\n'
                                       '- Evaluate whether the predicted answer includes specific '
                                       'details rather than just generic points. It should provide '
                                       'comprehensive information that is tied to specific elements '
                                       'of the video.\n'
                                       '- Consider synonyms or paraphrases as valid matches.\n'
                                       '- Provide a single evaluation score that reflects the level '
                                       'of detail orientation of the prediction, considering both '
                                       'completeness and specificity.',
                             'user': 'Please evaluate the following video-based question-answer '
                                     'pair:\n'
                                     '\n'
                                     'Question: {question}\n'
                                     'Correct Answer: {answer}\n'
                                     'Predicted Answer: {pred}\n'
                                     '\n'
                                     'Provide your evaluation only as a detail orientation score '
                                     'where the detail orientation score is an integer value between '
                                     '0 and 5, with 5 indicating the highest level of detail '
                                     'orientation. Please generate the response in the form of a '
                                     "Python dictionary string with keys 'score', where its value is "
                                     'the detail orientation score in INTEGER, not STRING.DO NOT '
                                     'PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the '
                                     'Python dictionary string. For example, your response should '
                                     "look like this: {''score': 4.8}."},
    # Video-ChatGPT axis 3 (eval_video_oqa_vcgpt_3_context.py:55-74)
    'context': {'system': 'You are an intelligent chatbot designed for evaluating the contextual '
                          'understanding of generative outputs for video-based question-answer pairs. '
                          'Your task is to compare the predicted answer with the correct answer and '
                          'determine if the generated response aligns with the overall context of the '
                          "video content. Here's how you can accomplish the "
                          'task:------##INSTRUCTIONS: - Evaluate whether the predicted answer aligns '
                          'with the overall context of the video content. It should not provide '
                          'information that is out of context or misaligned.\n'
                          '- The predicted answer must capture the main themes and sentiments of the '
                          'video.\n'
                          '- Consider synonyms or paraphrases as valid matches.\n'
                          '- Provide your evaluation of the contextual understanding of the '
                          'prediction compared to the answer.',
                'user': 'Please evaluate the following video-based question-answer pair:\n'
                        '\n'
                        'Question: {question}\n'
                        'Correct Answer: {answer}\n'
                        'Predicted Answer: {pred}\n'
                        '\n'
                        'Provide your evaluation only as a contextual understanding score where the '
                        'contextual understanding score is an integer value between 0 and 5, with 5 '
                        'indicating the highest level of contextual understanding. Please generate '
                        "the response in the form of a Python dictionary string with keys 'score', "
                        'where its value is contextual understanding score in INTEGER, not STRING.DO '
                        'NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python '
                        'dictionary string. For example, your response should look like this: '
                        "{''score': 4.8}."},
    # Video-ChatGPT axis 4 (eval_video_oqa_vcgpt_4_temporal.py:50-68)
    'temporal': {'system': 'You are an intelligent chatbot designed for evaluating the temporal '
                           'understanding of generative outputs for video-based question-answer '
                           'pairs. Your task is to compare the predicted answer with the correct '
                           'answer and determine if they correctly reflect the temporal sequence of '
                           "events in the video content. Here's how you can accomplish the "
                           'task:------##INSTRUCTIONS: - Focus on the temporal consistency between '
                           'the predicted answer and the correct answer. The predicted answer should '
                           'correctly reflect the sequence of events or details as they are presented '
                           'in the video content.\n'
                           '- Consider synonyms or paraphrases as valid matches, but only if the '
                           'temporal order is maintained.\n'
                           '- Evaluate the temporal accuracy of the prediction compared to the '
                           'answer.',
                 'user': 'Please evaluate the following video-based question-answer pair:\n'
                         '\n'
                         'Question: {question}\n'
                         'Correct Answer: {answer}\n'
                         'Predicted Answer: {pred}\n'
                         '\n'
                         'Provide your evaluation only as a temporal accuracy score where the '
                         'temporal accuracy score is an integer value between 0 and 5, with 5 '
                         'indicating the highest level of temporal consistency. Please generate the '
                         "response in the form of a Python dictionary string with keys 'score', where "
                         'its value is the temporal accuracy score in INTEGER, not STRING.DO NOT '
                         'PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python '
                         'dictionary string. For example, your response should look like this: '
                         "{''score': 4.8}."},
    # Video-ChatGPT axis 5 (eval_video_oqa_vcgpt_5_consistency.py:56-78)
    'consistency': {'system': 'You are an intelligent chatbot designed for evaluating the consistency '
                              'of generative outputs for similar video-based question-answer pairs. '
                              'You will be given two very similar questions, a common answer common '
                              'to both the questions and predicted answers for the two questions '
                              '.Your task is to compare the predicted answers for two very similar '
                              'question, with a common correct answer and determine if they are '
                              "consistent. Here's how you can accomplish the "
                              'task:------##INSTRUCTIONS: - Focus on the consistency between the two '
                              'predicted answers and the correct answer. Both predicted answers '
                              'should correspond to the correct answer and to each other, and should '
                              'not contain any contradictions or significant differences in the '
                              'conveyed information.\n'
                              '- Both predicted answers must be consistent with each other and the '
                              'correct answer, in terms of the information they provide about the '
                              'video content.\n'
                              '- Consider synonyms or paraphrases as valid matches, but only if they '
                              'maintain the consistency in the conveyed information.\n'
                              '- Evaluate the consistency of the two predicted answers compared to '
                              'the correct answer.',
                    'user': 'Please evaluate the following video-based question-answer pair:\n'
                            '\n'
                            'Question 1: {question1}\n'
                            'Question 2: {question2}\n'
                            'Correct Answer: {answer}\n'
                            'Predicted Answer to Question 1: {pred1}\n'
                            'Predicted Answer to Question 2: {pred2}\n'
                            '\n'
                            'Provide your evaluation only as a consistency score where the '
                            'consistency score is an integer value between 0 and 5, with 5 indicating '
                            'the highest level of consistency. Please generate the response in the '
                            "form of a Python dictionary string with keys 'score', where its value is "
                            'the consistency score in INTEGER, not STRING.DO NOT PROVIDE ANY OTHER '
                            'OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. '
                            "For example, your response should look like this: {''score': 4.8}."},
    # ActivityNet/MSVD/MSRVTT OQA (eval_video_oqa_activitynet.py:43-61) — the
    # only axis whose judge returns {'pred': yes/no, 'score'}.
    'activitynet': {'system': 'You are an intelligent chatbot designed for evaluating the correctness '
                              'of generative outputs for question-answer pairs. Your task is to '
                              'compare the predicted answer with the correct answer and determine if '
                              "they match meaningfully. Here's how you can accomplish the "
                              'task:------##INSTRUCTIONS: - Focus on the meaningful match between the '
                              'predicted answer and the correct answer.\n'
                              '- Consider synonyms or paraphrases as valid matches.\n'
                              '- Evaluate the correctness of the prediction compared to the answer.',
                    'user': 'Please evaluate the following video-based question-answer pair:\n'
                            '\n'
                            'Question: {question}\n'
                            'Correct Answer: {answer}\n'
                            'Predicted Answer: {pred}\n'
                            '\n'
                            'Provide your evaluation only as a yes/no and score where the score is an '
                            'integer value between 0 and 5, with 5 indicating the highest meaningful '
                            'match. Please generate the response in the form of a Python dictionary '
                            "string with keys 'pred' and 'score', where value of 'pred' is  a string "
                            "of 'yes' or 'no' and value of 'score' is in INTEGER, not STRING.DO NOT "
                            'PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python '
                            'dictionary string. For example, your response should look like this: '
                            "{'pred': 'yes', 'score': 4.8}."},
    # MSVC captioning (eval_video_cap_msvc_correctness.py:56-75) — "Correct
    # Answers" plural: {answer} is the list of reference captions.
    'msvc_correctness': {'system': 'You are an intelligent chatbot designed for evaluating the '
                                   'factual accuracy of generative outputs for video-based '
                                   'question-answer pairs. Your task is to compare the predicted '
                                   'answer with these correct answers and determine if they are '
                                   "factually consistent. Here's how you can accomplish the "
                                   'task:------##INSTRUCTIONS: - Focus on the factual consistency '
                                   'between the predicted answer and the correct answer. The '
                                   'predicted answer should not contain any misinterpretations or '
                                   'misinformation.\n'
                                   '- The predicted answer must be factually accurate and align with '
                                   'the video content.\n'
                                   '- Consider synonyms or paraphrases as valid matches.\n'
                                   '- Evaluate the factual accuracy of the prediction compared to the '
                                   'answer.',
                         'user': 'Please evaluate the following video-based question-answer pair:\n'
                                 '\n'
                                 'Question: {question}\n'
                                 'Correct Answers: {answer}\n'
                                 'Predicted Answer: {pred}\n'
                                 '\n'
                                 'Provide your evaluation only as a factual accuracy score where the '
                                 'factual accuracy score is an integer value between 0 and 5, with 5 '
                                 'indicating the highest level of factual consistency. Please '
                                 'generate the response in the form of a Python dictionary string '
                                 "with keys 'score', where its value is the factual accuracy score in "
                                 'INTEGER, not STRING.DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR '
                                 'EXPLANATION. Only provide the Python dictionary string. For '
                                 "example, your response should look like this: {''score': 4.8}."},
    # MSVC captioning detail axis (eval_video_cap_msvc_detailedness.py:55-73)
    'msvc_detailedness': {'system': 'You are an intelligent chatbot designed for evaluating the '
                                    'detail orientation of generative outputs for video-based '
                                    'question-answer pairs. Your task is to compare the predicted '
                                    'answer with these correct answers and determine its level of '
                                    "detail, considering both completeness and specificity. Here's "
                                    'how you can accomplish the task:------##INSTRUCTIONS: - Check if '
                                    'the predicted answer covers all major points from the video. The '
                                    'response should not leave out any key aspects.\n'
                                    '- Evaluate whether the predicted answer includes specific '
                                    'details rather than just generic points. It should provide '
                                    'comprehensive information that is tied to specific elements of '
                                    'the video.\n'
                                    '- Consider synonyms or paraphrases as valid matches.\n'
                                    '- Provide a single evaluation score that reflects the level of '
                                    'detail orientation of the prediction, considering both '
                                    'completeness and specificity.',
                          'user': 'Please evaluate the following video-based question-answer pair:\n'
                                  '\n'
                                  'Question: {question}\n'
                                  'Correct Answers: {answer}\n'
                                  'Predicted Answer: {pred}\n'
                                  '\n'
                                  'Provide your evaluation only as a detail orientation score where '
                                  'the detail orientation score is an integer value between 0 and 5, '
                                  'with 5 indicating the highest level of detail orientation. Please '
                                  'generate the response in the form of a Python dictionary string '
                                  "with keys 'score', where its value is the detail orientation score "
                                  'in INTEGER, not STRING.DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR '
                                  'EXPLANATION. Only provide the Python dictionary string. For '
                                  "example, your response should look like this: {''score': 4.8}."},
}

# qa-dict key aliases accepted per placeholder (ours, the reference's
# per-sample qa_set short keys, and the jsonl capitalized keys).
_KEY_ALIASES = {
    "question": ("question", "q", "Q"),
    "answer": ("answer", "a", "A"),
    "pred": ("pred", "p", "P"),
    "question1": ("question1", "q1", "Q1"),
    "question2": ("question2", "q2", "Q2"),
    "pred1": ("pred1", "p1", "P1"),
    "pred2": ("pred2", "p2", "P2"),
}


def _lookup(qa: Dict, placeholder: str):
    for key in _KEY_ALIASES[placeholder]:
        if key in qa:
            return qa[key]
    raise KeyError(f"qa row has none of {_KEY_ALIASES[placeholder]}: {sorted(qa)}")


def build_messages(axis: str, qa: Dict) -> List[Dict[str, str]]:
    """Render the verbatim reference chat messages for one sample."""
    rubric = RUBRICS[axis]
    user = rubric["user"]
    placeholders = (
        ("question1", "question2", "answer", "pred1", "pred2")
        if axis == "consistency"
        else ("question", "answer", "pred")
    )
    for ph in placeholders:
        user = user.replace("{" + ph + "}", str(_lookup(qa, ph)))
    return [
        {"role": "system", "content": rubric["system"]},
        {"role": "user", "content": user},
    ]


def _client():
    try:
        from openai import AzureOpenAI
    except ImportError as e:  # pragma: no cover - offline environment
        raise RuntimeError("GPT judging needs the `openai` package and Azure credentials") from e
    # api_version matches the reference init() (eval_video_oqa_vcgpt_1_correctness.py:13-17)
    return AzureOpenAI(
        azure_endpoint=os.environ["AZURE_OPENAI_ENDPOINT"],
        api_key=os.environ["AZURE_OPENAI_KEY"],
        api_version=os.environ.get("AZURE_OPENAI_API_VERSION", "2024-02-15-preview"),
    )


def _judge_one(client, model_name: str, axis: str, qa: Dict) -> Dict:
    # completion params verbatim from the reference interaction()
    # (eval_video_oqa_vcgpt_1_correctness.py:22-32)
    completion = client.chat.completions.create(
        model=model_name,
        messages=build_messages(axis, qa),
        temperature=0.7,
        max_tokens=800,
        top_p=0.95,
        frequency_penalty=0,
        presence_penalty=0,
        stop=None,
    )
    return ast.literal_eval(completion.choices[0].message.content)


def judge_results(
    results_file: str,
    output_dir: str,
    axis: str = "activitynet",
    model_name: Optional[str] = None,
    num_workers: int = 8,
    limit: Optional[int] = None,
) -> Dict:
    """Run (or resume) judging; returns {accuracy, mean_score, judged}."""
    os.makedirs(output_dir, exist_ok=True)
    rows: List[dict] = [json.loads(line) for line in open(results_file) if line.strip()]
    if limit:
        rows = rows[:limit]
    client = _client()
    model_name = model_name or os.environ.get("AZURE_OPENAI_DEPLOYNAME", "gpt-3.5-turbo")

    def work(idx_row):
        idx, row = idx_row
        key = row.get("question_id") or f"row{idx}"
        cache = os.path.join(output_dir, f"{key}.json")
        if os.path.exists(cache):
            return
        verdict = _judge_one(client, model_name, axis, row)
        with open(cache, "w") as f:
            json.dump([verdict, row], f)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(pool.map(work, enumerate(rows)))
    return aggregate_judgments(output_dir)


def aggregate_judgments(output_dir: str) -> Dict:
    """Aggregate cached per-sample judgments. The reference computes mean 0-5
    score for every axis (eval_video_oqa_vcgpt_1_correctness.py:179-189) and
    additionally yes-ratio accuracy for the ActivityNet-style judge
    (eval_video_oqa_activitynet.py:162-189)."""
    yes = 0
    n_pred = 0
    scores = []
    n = 0
    for fname in os.listdir(output_dir):
        if not fname.endswith(".json"):
            continue
        verdict, _ = json.load(open(os.path.join(output_dir, fname)))
        n += 1
        if "pred" in verdict:
            n_pred += 1
            if str(verdict["pred"]).lower() == "yes":
                yes += 1
        if "score" in verdict:
            scores.append(float(verdict["score"]))
    return {
        "judged": n,
        "accuracy": yes / n_pred if n_pred else 0.0,
        "mean_score": sum(scores) / len(scores) if scores else 0.0,
    }


def main(argv=None):  # pragma: no cover - needs Azure access
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--axis", default="activitynet", choices=sorted(RUBRICS))
    p.add_argument("--model-name", default=None)
    p.add_argument("--num-workers", type=int, default=8)
    args = p.parse_args(argv)
    print(json.dumps(judge_results(args.results, args.output_dir, args.axis, args.model_name, args.num_workers)))


if __name__ == "__main__":
    main()
