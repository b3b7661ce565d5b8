#!/usr/bin/env python
"""Training CLI of the port (fgvc_tpu/cli/train.py): the mixed recipe on one
card, on YouTube-VOS + FlyingThings3D or on the JAX package's procedural
data.

    python -m fgvc_tpu_torch.cli.train --ytv-root <ytv> --flyingthings-root <ft> \
        [--ytv-list youtube2018_train.json] --work-dir runs/mixed \
        [--config f.json] [--teacher t.pth] [--synthetic-val | --val-data-root <pkls>] \
        [--device cuda|cpu]
    python -m fgvc_tpu_torch.cli.train --synthetic --synthetic-mode structured \
        --max-steps N --work-dir runs/mixed ...

    python -m fgvc_tpu_torch.cli.launch --nprocs N -- \
        python -m fgvc_tpu_torch.cli.train ... [--device cpu]

As in the JAX CLI, --synthetic, or no --ytv-root, trains on procedural data;
otherwise FlyingThingsYtvDataset reads the two trees (frames decoded by the
port's own codecs: JPEG, PNG and the WebP cleanpass), an epoch is
len(videos) // batch_size steps, and a resumed run skips the batches of
the checkpointed steps.  Settings layer as in the JAX CLI: TrainConfig
defaults, then --config (a JSON object of TrainConfig fields, e.g.
{"compute_dtype": "bfloat16"}, which has no flag in either CLI), then
explicit flags.  Runs on the CUDA card unless --device cpu is given.

Several processes (a rank of cli.launch, or --coordinator, --num-processes
and --process-id) train data-parallel: --batch-size is the global batch,
rank r makes its slice and runs on cuda:(r % cards) (or the CPU), over NCCL
where every rank has a card of its own and gloo otherwise (the backend is
printed); process 0 writes the work directory.  --platform tpu is refused.
"""

import argparse
import dataclasses
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="fgvc_tpu_torch mixed training")
    parser.add_argument("--ytv-root", default=None,
                        help="YouTube-VOS root (train/JPEGImages_s256/<video>/*.jpg)")
    parser.add_argument("--flyingthings-root", default=None,
                        help="FlyingThings3D root (frames_cleanpass/TRAIN, optical_flow/TRAIN)")
    parser.add_argument("--ytv-list", default=None,
                        help="JSON of {video: [frames]} (or {'videos': ...}) to train on; "
                             "default: every *.jpg of each video directory")
    parser.add_argument("--work-dir", default="runs/mixed")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic-mode", default="noise",
                        choices=["noise", "structured", "movi"],
                        help="structured = textured scenes with exact flow, noise = "
                             "iid noise (smoke), movi = the rec branch on MOVi scene "
                             "pairs (--movi-root), sup/adversarial procedural")
    parser.add_argument("--movi-root", default=None,
                        help="directory of generate_movi.py pickles (--synthetic-mode movi)")
    parser.add_argument("--config", default=None,
                        help="JSON file of TrainConfig fields over the defaults; "
                             "explicit flags win over it")
    parser.add_argument("--batch-size", type=int, default=None, help="global batch (default 4)")
    parser.add_argument("--crop", type=int, default=None, help="train crop size (default 256)")
    parser.add_argument("--radius", type=int, default=None,
                        help="correlation radius (default 24)")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--log-interval", type=int, default=50)
    parser.add_argument("--ckpt-interval", type=int, default=None,
                        help="checkpoint cadence in steps (default: half the run)")
    parser.add_argument("--lr", type=float, default=None, help="peak learning rate (default 1e-3)")
    parser.add_argument("--teacher", default=None,
                        help="teacher init: a reference .pth, or a port checkpoint "
                             "(step_N directory or latest/best pointer) whose "
                             "trained student becomes the frozen teacher")
    parser.add_argument("--teacher-ema", type=float, default=None)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--seed", type=int, default=None, help="train seed (default 0)")
    parser.add_argument("--val-data-root", default=None,
                        help="TAP-Vid DAVIS pickles for mid-training validation")
    parser.add_argument("--val-interval", type=int, default=None)
    parser.add_argument("--val-videos", type=int, default=4)
    parser.add_argument("--synthetic-val", action="store_true",
                        help="mid-training validation on synthetic pickles")
    parser.add_argument("--precision", default=None, choices=["highest", "high", "default"],
                        help="correlation matmul precision (default high = bf16x3; "
                             "the backbone is float32 in all three)")
    parser.add_argument("--l1-weight", type=float, default=None)
    parser.add_argument("--sup-weight", type=float, default=None)
    parser.add_argument("--corr-da-weight", type=float, default=None)
    parser.add_argument("--grad-clip", type=float, default=None)
    parser.add_argument("--loss-scale", type=float, default=None)
    parser.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                        help="recompute the student's activations in the backward")
    parser.add_argument("--fused-encoder", action=argparse.BooleanOptionalAction, default=None,
                        help="one student pass for the rec + sup pairs (union-batch BN)")
    parser.add_argument("--check-numerics", action=argparse.BooleanOptionalAction,
                        default=None, help="raise on the first non-finite loss or gradient")
    parser.add_argument("--profile", default=None, metavar="LOGDIR",
                        help="write a torch.profiler trace (LOGDIR/trace.json)")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--platform", default=None, choices=["cpu", "tpu"],
                        help="the JAX CLI's platform switch: 'cpu' is --device cpu; "
                             "'tpu' is refused")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.platform == "tpu":
        parser.error("--platform tpu: fgvc_tpu_torch trains on a CUDA card (or --device cpu); "
                     "the TPU trainer is fgvc_tpu.cli.train")
    device = "cpu" if args.platform == "cpu" else args.device

    from fgvc_tpu_torch.apis.train import make_synthetic_val_fn, make_tapvid_val_fn, train_model
    from fgvc_tpu_torch.config import TrainConfig, check_train_ported, config_from_file
    from fgvc_tpu_torch.core.checkpoint import latest_checkpoint
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds_mod
    from fgvc_tpu_torch.device import resolve_device
    from fgvc_tpu_torch.parallel import dist
    from fgvc_tpu_torch.utils.profiler import trace

    cfg = TrainConfig()
    if args.config:
        cfg = config_from_file(args.config, cfg)
    flag_overrides = {
        k: v
        for k, v in (
            ("radius", args.radius), ("crop_size", args.crop), ("batch_size", args.batch_size),
            ("lr", args.lr), ("seed", args.seed), ("grad_clip", args.grad_clip),
            ("loss_weight_l1", args.l1_weight), ("loss_weight_sup", args.sup_weight),
            ("loss_weight_corr_da", args.corr_da_weight), ("matmul_precision", args.precision),
            ("loss_scale", args.loss_scale), ("remat", args.remat),
            ("fused_encoder", args.fused_encoder), ("check_numerics", args.check_numerics),
        )
        if v is not None
    }
    cfg = dataclasses.replace(cfg, **flag_overrides)
    coords = dist.coordinates_from_flags(args.coordinator, args.num_processes, args.process_id)
    rank, world = (coords[2], coords[1]) if coords else (0, 1)
    check_train_ported(cfg, world=world)
    real = not args.synthetic and args.ytv_root
    if real and not args.flyingthings_root:
        parser.error("--ytv-root needs --flyingthings-root (the flow-labeled branch)")
    resolve_device(device)  # no card and no --device cpu: refuse before any work
    if coords:
        device = dist.rank_device(device, rank)
        if device != "cpu":
            import torch

            torch.cuda.set_device(device)
        backend = dist.initialize_training(*coords, device=device)
        print(f"rank {rank} of {world} on {device}, backend {backend}", flush=True)

    if real:
        dataset = ds_mod.FlyingThingsYtvDataset(args.ytv_root, args.flyingthings_root,
                                                ytv_list=args.ytv_list, crop=cfg.crop_size,
                                                seed=cfg.seed)
    elif args.synthetic_mode == "movi":
        if not args.movi_root:
            parser.error("--synthetic-mode movi needs --movi-root")
        dataset = ds_mod.MoviMixedDataset(args.movi_root, crop=cfg.crop_size, seed=cfg.seed)
    elif args.synthetic_mode == "structured":
        dataset = ds_mod.StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed)
    else:
        dataset = ds_mod.SyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed)

    steps_per_epoch = args.steps_per_epoch or max(len(dataset) // cfg.batch_size, 1)
    total = args.max_steps or cfg.max_epochs * steps_per_epoch
    # resume: the loader starts at the checkpointed step
    skip = 0
    if not args.no_resume and (latest := latest_checkpoint(args.work_dir)):
        skip = min(int(os.path.basename(latest).split("_")[-1]), total)
    batches = ds_mod.make_batches(dataset, cfg.batch_size, total, skip=skip, rank=rank,
                                  world=world)

    if rank != 0 or not (args.val_data_root or args.synthetic_val):
        val_fn = None  # process 0 validates and broadcasts the metrics
    elif args.val_data_root:
        val_fn = make_tapvid_val_fn(args.val_data_root, max_videos=args.val_videos, device=device)
    else:
        val_fn = make_synthetic_val_fn(args.work_dir, seed=cfg.seed, device=device)
    try:
        with trace(args.profile if rank == 0 else None):
            train_model(
                cfg, batches, args.work_dir,
                steps_per_epoch=steps_per_epoch,
                max_steps=args.max_steps,
                log_interval=args.log_interval,
                ckpt_interval=args.ckpt_interval,
                resume=not args.no_resume,
                teacher_init=args.teacher,
                teacher_ema=args.teacher_ema,
                val_fn=val_fn,
                val_interval=args.val_interval
                or (steps_per_epoch * max(cfg.max_epochs // 2, 1) if val_fn else None),
                device=device,
            )
    finally:
        dist.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
