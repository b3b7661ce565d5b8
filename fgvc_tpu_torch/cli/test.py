#!/usr/bin/env python
"""Evaluation CLI of the port (fgvc_tpu/cli/test.py): TAP-Vid-DAVIS point
tracking and DAVIS-2017 VOS.

    python -m fgvc_tpu_torch.cli.test --task davis --data-root <pkls> \
        [--checkpoint ckpt.pth|WORK_DIR/latest] [--max-videos N] [--output-dir DIR] \
        [--config cfg.json] [--input-size N] \
        [--precision highest|high|default] [--spatial-devices S] \
        [--device cuda|cpu] [--profile LOGDIR]
    python -m fgvc_tpu_torch.cli.test --task vos --data-root <DAVIS tree> \
        [--list-path val.txt] [--save-mem] [--hard-prop] [...]

Prints the task's metrics as JSON.  Runs on the CUDA card unless --device
cpu is given.  --profile writes a torch.profiler trace of the whole run
(LOGDIR/trace.json, with the harness's propagate[i] and collect[i] spans and
the CUDA kernels).
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="fgvc_tpu_torch evaluation")
    parser.add_argument("--task", required=True, choices=["davis", "vos"])
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--list-path", default=None,
                        help="VOS: sequence list (.txt, one per line, or .json)")
    parser.add_argument("--checkpoint", default=None,
                        help="reference .pth (mmcv or torchvision naming), or a "
                             "training checkpoint of fgvc_tpu_torch.cli.train "
                             "(WORK_DIR/latest, WORK_DIR/best or a step_N dir)")
    parser.add_argument("--max-videos", type=int, default=None)
    parser.add_argument("--output-dir", default="eval_results")
    parser.add_argument("--config", default=None,
                        help="JSON file of TestConfig fields over the task preset; "
                             "explicit flags win over it")
    parser.add_argument("--input-size", type=int, default=None,
                        help="the eval resolution (square; task preset 256)")
    parser.add_argument(
        "--precision",
        default=None,
        choices=["highest", "high", "default"],
        help="affinity matmul precision (task preset: highest; "
             "default = bf16 multiplies)",
    )
    parser.add_argument(
        "--save-mem",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="stream features inside the propagation loop (full-res VOS, "
             "long videos)",
    )
    parser.add_argument(
        "--hard-prop",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="VOS: argmax->one-hot re-encode the value bank each step",
    )
    parser.add_argument(
        "--spatial-devices",
        type=int,
        default=None,
        help="spatial-parallel propagation: shard each frame's query rows "
             "over the first S cards (with --device cpu: S row blocks on "
             "the CPU)",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the tracker runs (the counterpart of "
                             "fgvc_tpu's --platform)")
    parser.add_argument(
        "--profile",
        default=None,
        metavar="LOGDIR",
        help="write a torch.profiler device+host trace (LOGDIR/trace.json)",
    )
    args = parser.parse_args(argv)

    import dataclasses

    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task
    from fgvc_tpu_torch.config import config_from_file
    from fgvc_tpu_torch.utils.profiler import trace

    base = TASK_CONFIGS[args.task]
    if args.config:
        base = config_from_file(args.config, base)
    overrides = {}
    if args.input_size:
        overrides["input_size"] = (args.input_size, args.input_size)
    if args.precision:
        overrides["matmul_precision"] = args.precision
    if args.save_mem is not None:
        overrides["save_mem"] = args.save_mem
    if args.hard_prop is not None:
        overrides["hard_prop"] = args.hard_prop
    with trace(args.profile):
        results = run_task(
            args.task,
            args.data_root,
            checkpoint=args.checkpoint,
            list_path=args.list_path,
            max_videos=args.max_videos,
            output_dir=args.output_dir,
            test_cfg=dataclasses.replace(base, **overrides),
            device=args.device,
            spatial_devices=args.spatial_devices,
        )
    print(json.dumps(results, indent=2, default=float))


if __name__ == "__main__":
    main()
