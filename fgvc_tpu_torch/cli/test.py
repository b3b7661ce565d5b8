#!/usr/bin/env python
"""Evaluation CLI of the port (fgvc_tpu/cli/test.py): TAP-Vid-DAVIS and
TAP-Vid-Kinetics point tracking, JHMDB pose and BADJA keypoint propagation,
and DAVIS-2017 VOS.

    python -m fgvc_tpu_torch.cli.test --task davis|kinetics --data-root <pkls> \
        [--query-mode first|strided] [--model vanilla|raft] \
        [--decode-impl upsample|window|coarse] [--upload-format rgb|yuv420] \
        [--visibility-mode none|heatmap] [--visibility-threshold X] \
        [--backbone NAME] [--checkpoint ckpt.pth|WORK_DIR/latest] \
        [--max-videos N] [--output-dir DIR] \
        [--config cfg.json] [--input-size N] \
        [--precision highest|high|default] [--spatial-devices S] \
        [--local-devices G] [--bank-devices N] \
        [--coordinator HOST:PORT --num-processes N --process-id I] \
        [--attention-impl pallas|tiled|dense|c2f|flow_guided] \
        [--topk-impl exact|segmented|certified|approx] \
        [--device cuda|cpu] [--profile LOGDIR]
    python -m fgvc_tpu_torch.cli.test --task kinetics --data-root <clips> \
        --annotations tapvid_kinetics.csv [...]
    python -m fgvc_tpu_torch.cli.test --task jhmdb --data-root <JHMDB root> \
        [--list-path <dir of val_list.txt>] [...]
    python -m fgvc_tpu_torch.cli.test --task badja --data-root <BADJA root> \
        [--list-path <dir of joint_annotations/>] [...]
    python -m fgvc_tpu_torch.cli.test --task vos --data-root <DAVIS tree> \
        [--list-path val.txt] [--save-mem] [--hard-prop] [...]

--attention-impl picks the propagation's attention: 'pallas' (the top-k
attention kernel, the default), 'tiled', 'dense', 'c2f' or 'flow_guided';
--topk-impl the top-k of 'tiled' ('approx' and 'certified' take exact
candidates off the TPU).  --annotations evaluates TAP-Vid-Kinetics straight
from the released CSV and --data-root's clips (<video_id>.mp4/.mkv/.webm,
decoded by the port's own reader: VP8, VP9 and Motion-JPEG in
WebM/Matroska, MPEG-4 Part 2 and Motion-JPEG in MP4/MOV; a clip in another
codec stops the run with its path and codec).  --model raft tracks TAP-Vid points by chaining RAFT's flows (an official
RAFT .pth as --checkpoint, or seeded weights).  Prints the task's metrics as
JSON.  Runs on the CUDA card unless --device cpu is given.  --profile
writes a torch.profiler trace of the whole run
(LOGDIR/trace.json, with the harness's propagate[i] and collect[i] spans and
the CUDA kernels).

The scaling axes: --local-devices G round-robins whole videos over G cards
(with --spatial-devices S: G groups of S cards each); --spatial-devices S
shards each frame's query rows; --bank-devices N shards the feature bank's
frames (--attention-impl tiled only).  With --device cpu a count means that
many copies of the CPU.  Several processes, started by

    python -m fgvc_tpu_torch.cli.launch --nprocs N -- python -m fgvc_tpu_torch.cli.test ...

(or given --coordinator, --num-processes and --process-id each), join a gloo
group, evaluate the videos [rank::world] and print the metrics of all of
them; only rank 0 writes --output-dir.  Without device flags rank r runs on
cuda:{r % device count}.
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="fgvc_tpu_torch evaluation")
    parser.add_argument("--task", required=True,
                        choices=["davis", "kinetics", "jhmdb", "badja", "vos"])
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--list-path", default=None,
                        help="VOS: sequence list (.txt, one per line, or .json); "
                             "JHMDB: the directory of val_list.txt; BADJA: the "
                             "directory of joint_annotations/ (both default to "
                             "--data-root)")
    parser.add_argument("--annotations", default=None, metavar="CSV",
                        help="TAP-Vid-Kinetics annotation CSV: evaluate --data-root's "
                             "video clips directly (datasets/tapvid_kinetics.py), "
                             "without per-video pickles")
    parser.add_argument("--query-mode", default="first", choices=["first", "strided"],
                        help="TAP-Vid query sampling: each track's first visible "
                             "frame, or every 5th frame where it is visible")
    parser.add_argument("--checkpoint", default=None,
                        help="reference .pth (mmcv or torchvision naming), or a "
                             "training checkpoint of fgvc_tpu_torch.cli.train "
                             "(WORK_DIR/latest, WORK_DIR/best or a step_N dir)")
    parser.add_argument(
        "--model",
        default="vanilla",
        choices=["vanilla", "raft"],
        help="vanilla = label-propagation tracker; raft = flow-chaining baseline",
    )
    parser.add_argument(
        "--backbone",
        default="resnet18_d1",
        help="eval encoder from the zoo (models/zoo.py): resnet18_d1 "
             "(paper default), hrnet_w18, dino_vit_s8/s16/b8, vit_small_d8, "
             "swin_tiny, resnet18_mast, resnet18_pos — the reference swaps "
             "the config's backbone dict the same way (ablations)",
    )
    parser.add_argument("--max-videos", type=int, default=None)
    parser.add_argument("--output-dir", default="eval_results")
    parser.add_argument("--config", default=None,
                        help="JSON file of TestConfig fields over the task preset; "
                             "explicit flags win over it")
    parser.add_argument("--input-size", type=int, default=None,
                        help="the eval resolution (square; task preset 256, JHMDB "
                             "320; BADJA reads 320 x 512 and VOS 480 x 880 "
                             "whatever it says)")
    parser.add_argument(
        "--precision",
        default=None,
        choices=["highest", "high", "default"],
        help="affinity matmul precision (task preset: highest; "
             "default = bf16 multiplies)",
    )
    parser.add_argument(
        "--attention-impl",
        default=None,
        choices=["pallas", "tiled", "dense", "c2f", "flow_guided"],
        help="propagation attention: the top-k attention kernel (pallas, the "
             "task preset), tiled windows, dense query chunks, coarse-to-fine, "
             "or flow-guided windows",
    )
    parser.add_argument(
        "--topk-impl",
        default=None,
        choices=["exact", "segmented", "certified", "approx"],
        help="top-k implementation of attention_impl 'tiled' (the pallas "
             "kernel is always exact)",
    )
    parser.add_argument(
        "--decode-impl",
        default=None,
        choices=["upsample", "window", "coarse"],
        help="coordinate decode: full-res upsample (reference-exact; "
             "'window' decodes as it), or feature-res soft-argmax (coarse)",
    )
    parser.add_argument(
        "--upload-format",
        default=None,
        choices=["rgb", "yuv420"],
        help="host->device wire format: raw uint8 RGB (3 B/px) or I420 "
             "chroma-subsampled planes (1.5 B/px), encoded on the host and "
             "decoded on the device",
    )
    parser.add_argument(
        "--visibility-mode",
        default=None,
        choices=["none", "heatmap"],
        help="point-tracking visibility prediction: none = constant zeros "
             "(reference parity; AJ/OA degenerate), heatmap = peak-ratio "
             "estimate",
    )
    parser.add_argument(
        "--visibility-threshold",
        type=float,
        default=None,
        help="peak_t / peak_query ratio above which a point counts visible",
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
             "the CPU). With --local-devices G: G video groups x S-way row "
             "sharding (needs G*S cards)",
    )
    parser.add_argument(
        "--local-devices",
        type=int,
        default=None,
        help="single-process data-parallel eval over N cards (videos "
             "round-robin; all five tasks; with --device cpu: N copies of the CPU)",
    )
    parser.add_argument(
        "--bank-devices",
        type=int,
        default=None,
        help="bank-parallel propagation: shard the feature bank's FRAMES "
             "over N cards (memory scaling for long videos; distributed exact "
             "top-k). attention_impl 'tiled' only; exclusive with "
             "--spatial-devices and --local-devices",
    )
    parser.add_argument(
        "--coordinator",
        default=None,
        help="multi-process: HOST:PORT of rank 0's gloo rendezvous (videos "
             "shard rank::world; results allgather before scoring); "
             "cli.launch sets it through FGVC_COORDINATOR",
    )
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
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

    from fgvc_tpu_torch.parallel import dist

    # before anything touches a card
    dist.initialize_from_flags(args.coordinator, num_processes=args.num_processes,
                               process_id=args.process_id)
    try:
        _run(args)
    finally:
        dist.finalize()


def _run(args):
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task
    from fgvc_tpu_torch.config import config_from_file
    from fgvc_tpu_torch.parallel.dist import process_info
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
    if args.attention_impl:
        overrides["attention_impl"] = args.attention_impl
    if args.topk_impl:
        overrides["topk_impl"] = args.topk_impl
    if args.decode_impl:
        overrides["decode_impl"] = args.decode_impl
    if args.upload_format:
        overrides["upload_format"] = args.upload_format
    if args.visibility_mode:
        overrides["visibility_mode"] = args.visibility_mode
    if args.visibility_threshold is not None:
        overrides["visibility_threshold"] = args.visibility_threshold
    device = args.device
    rank, world = process_info()
    if (world > 1 and device == "cuda" and torch.cuda.is_available()
            and not (args.local_devices or args.spatial_devices or args.bank_devices)):
        device = f"cuda:{rank % torch.cuda.device_count()}"
    with trace(args.profile):
        results = run_task(
            args.task,
            args.data_root,
            checkpoint=args.checkpoint,
            list_path=args.list_path,
            max_videos=args.max_videos,
            output_dir=args.output_dir,
            test_cfg=dataclasses.replace(base, **overrides),
            device=device,
            spatial_devices=args.spatial_devices,
            local_devices=args.local_devices,
            bank_devices=args.bank_devices,
            query_mode=args.query_mode,
            backbone=args.backbone,
            model=args.model,
            annotations=args.annotations,
        )
    print(json.dumps(results, indent=2, default=float))


if __name__ == "__main__":
    main()
