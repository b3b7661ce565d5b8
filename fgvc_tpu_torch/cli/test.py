#!/usr/bin/env python
"""Evaluation CLI of the port (fgvc_tpu/cli/test.py, TAP-Vid-DAVIS):

    python -m fgvc_tpu_torch.cli.test --task davis --data-root <pkls> \
        [--checkpoint ckpt.pth] [--max-videos N] [--output-dir DIR] \
        [--device cuda|cpu]

Prints the TAP-Vid metrics as JSON.  Runs on the CUDA card unless
--device cpu is given.
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="fgvc_tpu_torch evaluation")
    parser.add_argument("--task", required=True, choices=["davis"])
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="reference .pth (mmcv or torchvision naming)")
    parser.add_argument("--max-videos", type=int, default=None)
    parser.add_argument("--output-dir", default="eval_results")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the tracker runs (the counterpart of "
                             "fgvc_tpu's --platform)")
    args = parser.parse_args(argv)

    from fgvc_tpu_torch.apis.test import run_task

    results = run_task(
        args.task,
        args.data_root,
        checkpoint=args.checkpoint,
        max_videos=args.max_videos,
        output_dir=args.output_dir,
        device=args.device,
    )
    print(json.dumps(results, indent=2, default=float))


if __name__ == "__main__":
    main()
