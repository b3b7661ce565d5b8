"""Evaluation harness of the port (fgvc_tpu/apis/test.py): TAP-Vid-DAVIS and
TAP-Vid-Kinetics point tracking, JHMDB pose and BADJA keypoint propagation,
and DAVIS-2017 VOS.

    run_task('davis' | 'kinetics', data_root, query_mode='first' | 'strided',
             model='vanilla' | 'raft', ...)
    run_task('jhmdb' | 'badja', data_root, list_path=None, ...)
    run_task('vos', data_root, list_path=None, test_cfg=None, device=None)

builds the tracker on the card (or on the device the caller names) over the
paper's ResNet-18-d1 or, with `backbone=`, any encoder of models/zoo.py,
evaluates every video of `data_root` and returns the task's metrics
(TAP-Vid's, PCK, or DAVIS J&F).  `model='raft'` tracks TAP-Vid points by
chaining RAFT's flows instead (build_raft_tracker).  `spatial_devices` S > 1
shards each frame's query rows over the first S cards (spatial-parallel
propagation); a list of devices is taken as given, so one card listed S
times runs S row blocks on it.

Every eval reads one video ahead on a worker thread and names its steps for
``--profile`` traces as the JAX harness does: ``propagate[i]`` around video
i's tracking and ``collect[i]`` around reading (and, for VOS, scoring) its
results.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from fgvc_tpu_torch.config import (
    BADJA_TEST_CFG,
    DAVIS_TEST_CFG,
    JHMDB_TEST_CFG,
    KINETICS_TEST_CFG,
    TestConfig,
)
from fgvc_tpu_torch.core.checkpoint import student_state_dict
from fgvc_tpu_torch.device import resolve_device
from fgvc_tpu_torch.models.raft import RAFT, RaftTracker
from fgvc_tpu_torch.models.resnet import init_flax_like, init_random, resnet18_d1
from fgvc_tpu_torch.models.tracker import Tracker
from fgvc_tpu_torch.models.weights import load_raft_pth, load_reference_pth, load_weights
from fgvc_tpu_torch.models.zoo import make_eval_backbone
from fgvc_tpu_torch.utils.profiler import annotate

TASK_CONFIGS: Dict[str, TestConfig] = {
    "davis": DAVIS_TEST_CFG,
    "kinetics": KINETICS_TEST_CFG,
    "jhmdb": JHMDB_TEST_CFG,
    "badja": BADJA_TEST_CFG,
    "vos": DAVIS_TEST_CFG,
}


SpatialDevices = Optional[Union[int, Sequence[Union[str, torch.device]]]]


def spatial_device_list(
    spatial_devices: SpatialDevices, device: Optional[Union[str, torch.device]] = None,
) -> Optional[List[torch.device]]:
    """The spatial devices of `--spatial-devices`: None for an int S <= 1
    (no row sharding, as fgvc_tpu); for an int S > 1 the first S CUDA cards,
    or S copies of the CPU where `device` is 'cpu'; a sequence of devices as
    given."""
    if spatial_devices is None:
        return None
    if not isinstance(spatial_devices, int):
        return [torch.device(d) for d in spatial_devices]
    S = spatial_devices
    if S <= 1:
        return None
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * S
    have = torch.cuda.device_count()
    if S > have:
        raise ValueError(f"{S}-way row sharding needs {S} local devices, have {have}")
    return [torch.device("cuda", i) for i in range(S)]


def build_tracker(
    test_cfg: TestConfig = DAVIS_TEST_CFG,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    spatial_devices: SpatialDevices = None,
    backbone: str = "resnet18_d1",
) -> Tracker:
    """Tracker over a zoo encoder (default: the paper's ResNet-18-d1), with
    weights from a reference ``.pth``, from the trained student of a port
    training checkpoint (a step_N directory or a latest/best pointer file;
    ResNet-18-d1 only), or seeded random weights.  Another `backbone` is
    built by models.zoo.make_eval_backbone, which also switches
    cfg.preprocess to what that encoder expects.  Runs on the CUDA card
    unless `device` names another; raises where there is no card and none
    was named.  With `spatial_devices` (spatial_device_list) it runs on the
    first of them."""
    spatial = spatial_device_list(spatial_devices, device)
    dev = resolve_device(device if spatial is None else spatial[0])
    if backbone != "resnet18_d1":
        model, pre = make_eval_backbone(backbone, checkpoint, input_hw=test_cfg.input_size,
                                        seed=seed, device=dev)
        if test_cfg.preprocess != pre:
            test_cfg = dataclasses.replace(test_cfg, preprocess=pre)
        return Tracker(model, test_cfg, dev, spatial_devices=spatial)
    model = resnet18_d1()
    if checkpoint is None:
        init_random(model, seed)
    elif checkpoint.endswith(".pth"):
        load_weights(model, load_reference_pth(checkpoint))
    else:
        # JAX orbax directories have no state.pt and are refused here
        load_weights(model, student_state_dict(checkpoint))
    return Tracker(model, test_cfg, dev, spatial_devices=spatial)


def build_raft_tracker(
    checkpoint: Optional[str] = None, iters: int = 12, seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> RaftTracker:
    """The RAFT baseline tracker: an official RAFT ``.pth`` (princeton-vl
    names) into RAFT(cnet_norm='batch'), or, without a checkpoint, seeded
    flax-like weights with cnet_norm 'none', as fgvc_tpu builds them.  Runs
    on the CUDA card unless `device` names another."""
    dev = resolve_device(device)
    if checkpoint is None:
        model = init_flax_like(RAFT(iters=iters, cnet_norm="none"),
                               torch.Generator().manual_seed(seed))
    elif checkpoint.endswith(".pth"):
        model = load_weights(RAFT(iters=iters, cnet_norm="batch"), load_raft_pth(checkpoint))
    else:
        raise ValueError(
            f"RAFT reads an official .pth checkpoint, not {checkpoint!r} (orbax "
            "directories of fgvc_tpu reach the port as an exported .pth)"
        )
    return RaftTracker(model, dev, iters=iters)


def _read_ahead(dataset, ids):
    """Yield dataset[i] for i in ids, reading one video ahead on a worker
    thread (fgvc_tpu/apis/test.py _read_ahead): the next video's file read
    and decode overlap this video's tracking."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = None
        for n, i in enumerate(ids):
            cur = fut.result() if fut is not None else dataset[i]
            fut = ex.submit(dataset.__getitem__, ids[n + 1]) if n + 1 < len(ids) else None
            yield cur


def eval_tapvid(tracker: Union[Tracker, RaftTracker], dataset, max_videos=None,
                output_dir=None) -> Dict[str, float]:
    """Track every video of `dataset` (a TapVidDataset) and score the
    results.  A tracker without the dispatch/collect split (RaftTracker)
    tracks inside the collect span."""
    n = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    ids = list(range(n))
    results = []
    for i, sample in zip(ids, _read_ahead(dataset, ids)):
        t0 = time.time()
        split = hasattr(tracker, "track_points_dispatch")
        with annotate(f"propagate[{i}]"):
            disp = (tracker.track_points_dispatch(sample["video"], sample["query_points"])
                    if split else None)
        with annotate(f"collect[{i}]"):
            out = (tracker.track_points_collect(disp) if split
                   else tracker.track_points(sample["video"], sample["query_points"]))
        print(
            f"[{i}] T={len(sample['video'])} P={sample['query_points'].shape[0]}"
            f" {time.time() - t0:.2f}s",
            flush=True,
        )
        results.append({
            "trajectories_gt": sample["trajectories"],
            "visibilities_gt": sample["visibilities"],
            "trajectories_pred": out["trajectories"],
            "visibilities_pred": out["visibilities"],
            "query_points": sample["query_points"],
        })
    return dataset.evaluate(results, output_dir=output_dir, indices=range(n))


def _heatmap_eval_loop(tracker: Tracker, dataset, n: int) -> List[np.ndarray]:
    """(T, P, 2) coordinates at the reader's decode size of the first n
    videos of a JHMDB or BADJA reader, one video read ahead."""
    ids = list(range(n))
    out = []
    for i, sample in zip(ids, _read_ahead(dataset, ids)):
        t0 = time.time()
        with annotate(f"propagate[{i}]"):
            disp = tracker.track_heatmaps_dispatch(
                sample["video"], sample["ref_maps"], tuple(sample["original_shape"]))
        with annotate(f"collect[{i}]"):
            out.append(tracker.track_heatmaps_collect(disp))
        print(f"[{i}] T={len(sample['video'])} P={sample['ref_maps'].shape[-1]}"
              f" {time.time() - t0:.2f}s", flush=True)
    return out


def eval_jhmdb(tracker: Tracker, dataset, max_videos=None, output_dir=None) -> Dict[str, float]:
    """Propagate every video's frame-0 joints (a JhmdbDataset) and score PCK
    at the original frame size."""
    n = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    preds = [np.transpose(c, (2, 1, 0)) for c in _heatmap_eval_loop(tracker, dataset, n)]
    return dataset.evaluate(preds, indices=range(n), output_dir=output_dir)  # (2, P, T) each


def eval_badja(tracker: Tracker, dataset, max_videos=None, output_dir=None) -> Dict[str, float]:
    """Propagate every video's frame-0 joints (a BadjaDataset) and score PCK
    at the reader's (320, 512)."""
    n = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    preds = _heatmap_eval_loop(tracker, dataset, n)  # (T, P, 2) at the reader's size
    return dataset.evaluate(preds, indices=range(n), output_dir=output_dir)


def eval_vos(tracker: Tracker, dataset, max_videos=None, output_dir=None) -> Dict[str, float]:
    """Propagate the first mask of every video of `dataset` (a
    DavisVosDataset, or anything with its __len__, __getitem__ and
    score_video), score each video as it finishes and pool the J&F stats;
    appends them to output_dir/result.txt."""
    from fgvc_tpu_torch.core.metrics.vos import aggregate_jf
    from fgvc_tpu_torch.datasets.davis_vos import write_results

    n = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    ids = list(range(n))
    stats = []
    for i, sample in zip(ids, _read_ahead(dataset, ids)):
        t0 = time.time()
        with annotate(f"propagate[{i}]"):
            disp = tracker.track_masks_dispatch(
                sample["video"], sample["first_mask"],
                tuple(sample["original_shape"]), sample["num_objects"],
            )
        with annotate(f"collect[{i}]"):
            masks = tracker.track_masks_collect(disp)
            dt = time.time() - t0
            s = dataset.score_video(i, masks)
        print(f"[{i}] T={len(sample['video'])} objects={sample['num_objects']}"
              f" {dt:.2f}s", flush=True)
        if s is not None:
            stats.append(s)
    results = aggregate_jf(stats)
    if output_dir:
        write_results(results, output_dir)
    return results


def run_task(
    task: str,
    data_root: str,
    checkpoint: Optional[str] = None,
    list_path: Optional[str] = None,
    max_videos: Optional[int] = None,
    output_dir: Optional[str] = None,
    test_cfg: Optional[TestConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    spatial_devices: SpatialDevices = None,
    query_mode: str = "first",
    backbone: str = "resnet18_d1",
    model: str = "vanilla",
) -> Dict[str, float]:
    """Mirror of `tools/test.py --task davis|kinetics|jhmdb|badja|vos
    [--query-mode strided] [--spatial-devices S] [--backbone NAME]
    [--model vanilla|raft]`.
    query_mode 'strided' (TAP-Vid tasks only) queries every track every 5
    frames where it is visible.  JHMDB and BADJA read their lists under
    `list_path`, by default `data_root`.  VOS reads every video at 480 x 880
    and BADJA at 320 x 512 whatever cfg.input_size says, as the JAX harness
    does.  `backbone` names the encoder (models/zoo.py).  `model='raft'`
    (TAP-Vid tasks only, one device, `backbone` unread) builds
    build_raft_tracker(checkpoint) instead of the label-propagation
    tracker."""
    if task not in TASK_CONFIGS:
        raise ValueError(f"unknown task {task!r}")
    if query_mode != "first" and task not in ("davis", "kinetics"):
        raise ValueError(
            f"--query-mode {query_mode!r} only applies to TAP-Vid point "
            f"tracking (davis/kinetics), not task {task!r}"
        )
    if model not in ("vanilla", "raft"):
        raise ValueError(f"model must be 'vanilla' or 'raft', got {model!r}")
    cfg = test_cfg or TASK_CONFIGS[task]
    if model == "raft":
        if spatial_devices is not None and (not isinstance(spatial_devices, int)
                                            or spatial_devices > 1):
            raise ValueError("--spatial-devices applies to the label-propagation tracker "
                             "only (RaftTracker has no dispatch/collect split)")
        if task not in ("davis", "kinetics"):
            raise ValueError("--model raft supports point-tracking tasks only")
        tracker = build_raft_tracker(checkpoint, seed=seed, device=device)
    else:
        tracker = build_tracker(cfg, checkpoint, seed=seed, device=device,
                                spatial_devices=spatial_devices, backbone=backbone)
    if task in ("davis", "kinetics"):
        from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

        ds = TapVidDataset(data_root, subset_name=task, query_mode=query_mode,
                           input_size=cfg.input_size)
        return eval_tapvid(tracker, ds, max_videos, output_dir=output_dir)
    if task == "jhmdb":
        from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset

        ds = JhmdbDataset(data_root, list_path or data_root, input_size=cfg.input_size)
        return eval_jhmdb(tracker, ds, max_videos, output_dir=output_dir)
    if task == "badja":
        from fgvc_tpu_torch.datasets.badja import BadjaDataset

        ds = BadjaDataset(data_root, list_path or data_root)
        return eval_badja(tracker, ds, max_videos, output_dir=output_dir)
    from fgvc_tpu_torch.datasets import davis_vos

    ds = davis_vos.DavisVosDataset(data_root, split_list=list_path)
    return eval_vos(tracker, ds, max_videos, output_dir=output_dir)
