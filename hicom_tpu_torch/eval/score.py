"""Scoring CLI: python -m hicom_tpu_torch.eval.score --benchmark videomme --results merge.json"""

from __future__ import annotations

import argparse
import glob
import json

from .common import merge_chunked_videomme
from . import scorers


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--benchmark", required=True,
                   choices=["videomme", "mvbench", "mlvu", "egoschema", "pope", "textvqa", "stvqa"])
    p.add_argument("--results", required=True, help="answer file (or glob of chunk files for videomme)")
    p.add_argument("--question-file", default=None)
    p.add_argument("--annotation-dir", default=None, help="pope: coco_pope_*.json dir")
    p.add_argument("--answers-json", default=None, help="egoschema: local answer map")
    p.add_argument("--video-types", default="short,medium,long")
    p.add_argument("--skip-missing", action="store_true", default=True)
    args = p.parse_args(argv)

    if args.benchmark == "videomme":
        files = sorted(glob.glob(args.results))
        try:
            results = json.load(open(files[0])) if len(files) == 1 else merge_chunked_videomme(files)
        except json.JSONDecodeError:
            results = merge_chunked_videomme(files)
        report = scorers.score_videomme(results, args.video_types.split(","), args.skip_missing)
    elif args.benchmark == "mvbench":
        report = scorers.score_mvbench(args.results)
    elif args.benchmark == "mlvu":
        report = scorers.score_mlvu(args.results)
    elif args.benchmark == "egoschema":
        report = scorers.score_egoschema_csv(args.results, args.answers_json)
    elif args.benchmark == "pope":
        report = scorers.score_pope_all(args.question_file, args.results, args.annotation_dir)
    elif args.benchmark in ("textvqa", "stvqa"):
        pred_list = [json.loads(line) for line in open(args.results)]
        ev = scorers.TextVQAAccuracyEvaluator() if args.benchmark == "textvqa" else scorers.STVQAAccuracyEvaluator()
        report = {"accuracy": ev.eval_pred_list(pred_list)}
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
