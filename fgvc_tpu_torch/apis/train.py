"""Training harness of the port (fgvc_tpu/apis/train.py): the loop around
MixedTrainer.

    train_model(cfg, batches, work_dir, steps_per_epoch, max_steps=None,
                device=None, val_fn=None, ...)

* one device a process (the card unless `device` names another); under a
  process group of several (fgvc_tpu_torch.cli.launch, --coordinator)
  each process steps on its slice of the global batch (MixedTrainer's
  data-parallel step), process 0 alone writes the log, TensorBoard, the
  checkpoints and the best pointer while the others wait at a barrier,
  validation runs on process 0 (the others pass no val_fn) and its metrics
  are broadcast, and a SIGTERM
  to any process stops them all at one step boundary (parallel.dist
  sync_stop, the JAX loop's _sync_stop);
* per global step a generator derived from (seed + 1, step) alone, and the
  loader resumed at the checkpointed step (make_batches(skip=)), so a
  resumed run repeats the uninterrupted one step for step;
* losses to work_dir/train_log.jsonl with steps_per_sec (and TensorBoard
  where tensorboardX imports);
* a checkpoint every `ckpt_interval` steps and at the end, resume from
  `latest`, best-metric tracking (`best` pointer and best.json) when
  `val_fn` reports `val_metric_key`, SIGTERM checkpoints and stops at the
  step boundary;
* the teacher from a reference .pth, or the trained student of a port
  checkpoint (a step_N directory or a latest/best pointer);
* mid-training validation (`make_tapvid_val_fn`, `make_synthetic_val_fn`):
  the student's current weights go through the port's Tracker and
  eval_tapvid, so the top-k attention kernel runs on the card mid-training.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import pickle
import signal
import time
from typing import Iterable, Optional, Union

import numpy as np
import torch

from fgvc_tpu_torch.config import TrainConfig
from fgvc_tpu_torch.core.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    student_state_dict,
    write_pointer,
)
from fgvc_tpu_torch.core.train import MixedTrainer, step_generator
from fgvc_tpu_torch.data_io.prefetch import prefetch_iter
from fgvc_tpu_torch.parallel.dist import alone, barrier, broadcast_object, sync_stop


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, momentum: float = 0.999) -> None:
    """teacher <- m * teacher + (1 - m) * student, parameters only (the
    JAX package mixes its params; the teacher's BN statistics stay)."""
    t = list(teacher.parameters())
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, list(student.parameters()), alpha=1.0 - momentum)


def _student_copy(trainer: MixedTrainer) -> torch.nn.Module:
    """The student's current weights as a float32 eval-mode module (the
    reference eval hook's copy_params -> eval twin; JAX's validation builds
    a float32 resnet18_d1 whatever the compute dtype)."""
    model = copy.deepcopy(trainer.backbone).eval()
    model.compute_dtype = None
    return model


def make_tapvid_val_fn(data_root: str, test_cfg=None, max_videos: int = 4,
                       device: Optional[Union[str, torch.device]] = None):
    """Mid-training evaluation on TAP-Vid-DAVIS pickles: val_fn(trainer)
    evaluates the student's current weights with the port's Tracker on up
    to `max_videos` videos and returns the TAP-Vid metrics."""
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, eval_tapvid
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.models.tracker import Tracker

    cfg = test_cfg or TASK_CONFIGS["davis"]
    dataset = TapVidDataset(data_root, subset_name="davis", query_mode="first",
                            input_size=cfg.input_size)

    def val_fn(trainer: MixedTrainer):
        tracker = Tracker(_student_copy(trainer), cfg, device or trainer.device)
        return eval_tapvid(tracker, dataset, max_videos=max_videos)

    return val_fn


def make_synthetic_val_fn(work_dir: str, num_videos: int = 2, frames: int = 6, size=(64, 64),
                          max_videos: int = 2, seed: int = 0,
                          device: Optional[Union[str, torch.device]] = None):
    """Mid-training validation without real data: tiny random TAP-Vid
    pickles under work_dir/synth_val (the JAX package's, made from the same
    seed), evaluated at their own size with a radius-3 window."""
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS

    root = os.path.join(work_dir, "synth_val")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for v in range(num_videos):
        path = os.path.join(root, f"synth{v}.pkl")
        rec = {
            "video": rng.integers(0, 256, (frames, *size, 3), dtype=np.uint8),
            "points": rng.uniform(0.2, 0.8, (4, frames, 2)).astype(np.float32),
            "occluded": np.zeros((4, frames), bool),
        }
        if not os.path.exists(path):
            with open(path, "wb") as f:
                pickle.dump(rec, f)
    cfg = dataclasses.replace(TASK_CONFIGS["davis"], input_size=tuple(size),
                              neighbor_range=6, tile=8)
    return make_tapvid_val_fn(root, test_cfg=cfg, max_videos=max_videos, device=device)


def _teacher_state(teacher_init: str):
    """The teacher's ResNet state dict: the trained student of a port
    checkpoint (a step_N directory or a latest/best pointer), else a
    reference .pth."""
    from fgvc_tpu_torch.models.weights import load_reference_pth

    is_pointer = os.path.isfile(teacher_init) and os.path.basename(teacher_init) in ("best", "latest")
    if is_pointer or os.path.isdir(teacher_init):
        return student_state_dict(teacher_init)
    return load_reference_pth(teacher_init)


def _log_val(work_dir, log_path, step, metrics, key, rule, best, trainer):
    """Append the metrics; on a new best, checkpoint and point `best` at it
    (the files on process 0 alone; every process keeps the best value).
    Returns the best value so far."""
    lead = trainer.rank == 0
    if lead:
        with open(log_path, "a") as f:
            f.write(json.dumps({"step": step, "val": metrics}, default=float) + "\n")
        print(f"[val @ {step}] {metrics}", flush=True)
    cur = metrics.get(key)
    if cur is None:
        return best
    if best is not None and not (cur > best if rule == "greater" else cur < best):
        return best
    if lead:
        save_checkpoint(work_dir, trainer)
        write_pointer(work_dir, "best", step)
        with open(os.path.join(work_dir, "best.json"), "w") as f:
            json.dump({"step": step, "metric": key, "value": float(cur)}, f)
        print(f"[best @ {step}] {key}={float(cur)}", flush=True)
    barrier()
    return float(cur)


def _save(work_dir, trainer, note="saved") -> None:
    """Checkpoint on process 0 while the others wait."""
    if trainer.rank == 0:
        print(f"{note} {save_checkpoint(work_dir, trainer)}", flush=True)
    barrier()


def train_model(
    cfg: TrainConfig,
    batches: Iterable,
    work_dir: str,
    steps_per_epoch: int,
    max_steps: Optional[int] = None,
    ckpt_interval: Optional[int] = None,
    log_interval: int = 50,
    resume: bool = True,
    teacher_init: Optional[str] = None,
    teacher_ema: Optional[float] = None,
    val_fn=None,
    val_interval: Optional[int] = None,
    val_metric_key: str = "average_pts_within_thresh",
    val_rule: str = "greater",
    device: Optional[Union[str, torch.device]] = None,
) -> MixedTrainer:
    """Run mixed training over an iterable of host batches (the batches
    from the resumed step on); returns the trainer."""
    from fgvc_tpu_torch.models.weights import load_weights

    trainer = MixedTrainer(cfg, device).init(cfg.seed, steps_per_epoch)
    lead = trainer.rank == 0
    if lead:
        os.makedirs(work_dir, exist_ok=True)
    barrier()
    if teacher_init:
        load_weights(trainer.teacher, _teacher_state(teacher_init))
        print(f"teacher <- {teacher_init}", flush=True)

    best_metric = None
    if resume and (path := latest_checkpoint(work_dir)):
        restore_checkpoint(path, trainer)
        if lead:
            print(f"resumed from {path} (step {trainer.step})", flush=True)
        best_path = os.path.join(work_dir, "best.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                meta = json.load(f)
            if meta.get("metric") == val_metric_key:
                best_metric = meta.get("value")

    total = max_steps or cfg.max_epochs * steps_per_epoch
    ckpt_interval = ckpt_interval or max(total // 2, 1)
    # process 0 alone holds val_fn; the others learn from it when it validates
    val_interval = broadcast_object(val_interval if val_fn is not None else None)
    preempt = {"flag": False}

    def _on_sigterm(signum, frame):
        preempt["flag"] = True
        print("SIGTERM: will checkpoint and stop at the step boundary", flush=True)

    restore = contextlib.ExitStack()
    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
        restore.callback(signal.signal, signal.SIGTERM, prev)
    except ValueError:  # not the main thread: run without the handler
        pass

    log_path = os.path.join(work_dir, "train_log.jsonl")
    tb = None
    try:
        if lead:
            from tensorboardX import SummaryWriter

            tb = SummaryWriter(os.path.join(work_dir, "tb"))
            restore.callback(tb.close)
    except Exception:
        pass

    with restore:
        t0 = time.time()
        last_logged = trainer.step
        for batch in prefetch_iter(batches, depth=2):
            step = trainer.step
            if step >= total:
                break
            losses = trainer.train_step(batch, step_generator(cfg.seed, step))
            if cfg.check_numerics and not bool(losses["all_finite"]):
                vals = {k: float(v) for k, v in losses.items() if k != "all_finite"}
                raise FloatingPointError(f"non-finite loss or gradient at step {step + 1}: {vals}")
            if teacher_ema is not None:
                ema_update(trainer.teacher, trainer.backbone, teacher_ema)
            step = trainer.step

            if lead and (step % log_interval == 0 or step == total):
                vals = {k: float(v) for k, v in losses.items()}
                vals["step"] = step
                vals["steps_per_sec"] = (step - last_logged) / max(time.time() - t0, 1e-9)
                last_logged, t0 = step, time.time()
                with open(log_path, "a") as f:
                    f.write(json.dumps(vals) + "\n")
                if tb:
                    for k, v in vals.items():
                        tb.add_scalar(k, v, step)
                print(f"step {step}/{total} " + " ".join(f"{k}={v:.4f}" for k, v in vals.items()),
                      flush=True)
            if step % ckpt_interval == 0 or step == total:
                _save(work_dir, trainer)
            if val_interval and (step % val_interval == 0 or step == total):
                if lead:
                    with alone():  # the others wait in the broadcast
                        metrics = val_fn(trainer)
                metrics = broadcast_object(metrics if lead else None)
                best_metric = _log_val(work_dir, log_path, step, metrics,
                                       val_metric_key, val_rule, best_metric, trainer)
            if sync_stop(preempt["flag"], trainer.collective_device):
                if step % ckpt_interval != 0 and step != total:
                    _save(work_dir, trainer, "preempted: saved")
                print(f"preempted: stopping at step {step}", flush=True)
                break
    return trainer
