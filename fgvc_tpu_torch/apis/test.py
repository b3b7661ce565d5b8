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
chaining RAFT's flows instead (build_raft_tracker).  The scaling axes, as the
JAX harness has them:

* `spatial_devices` S > 1 shards each frame's query rows over the first S
  cards (spatial-parallel propagation);
* `local_devices` G > 1 round-robins whole videos over the first G cards
  (data-parallel, one process), or over G groups of S cards with
  `spatial_devices` S (dp x sp);
* `bank_devices` n > 1 shards the feature bank's frames over the first n
  cards (bank-parallel propagation, attention_impl 'tiled' only);
* several processes (`parallel/dist.py`, `cli/launch.py`) each evaluate the
  videos [rank::world] and score the merged results.

With `device='cpu'` a count N means N copies of the CPU; a list of devices
is taken as given, so one card listed N times runs the path of N cards.

Every eval reads one video ahead on a worker thread and names its steps for
``--profile`` traces as the JAX harness does: ``propagate[i]`` around video
i's tracking and ``collect[i]`` around reading (and, for VOS, scoring) its
results.
"""

from __future__ import annotations

import copy
import dataclasses
import os
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
from fgvc_tpu_torch.models.tracker import Tracker, full_device
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


Device = Union[str, torch.device]
SpatialDevices = Optional[Union[int, Sequence[Device]]]
# a count, or entries each a device (dp) or a sequence of devices (dp x sp)
LocalDevices = Optional[Union[int, Sequence[Union[Device, Sequence[Device]]]]]


def _first_devices(n: int, device: Optional[Device], needs: str) -> List[torch.device]:
    """n copies of the CPU where `device` is 'cpu', else the first n CUDA
    cards; `needs` opens the message where there are fewer."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"{needs} needs {n} local devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def _axis_devices(devices: SpatialDevices, device: Optional[Device],
                  what: str) -> Optional[List[torch.device]]:
    """None for an int N <= 1; for an int N > 1 _first_devices; a sequence
    of devices as given."""
    if devices is None:
        return None
    if not isinstance(devices, int):
        return [torch.device(d) for d in devices]
    return None if devices <= 1 else _first_devices(devices, device, f"{devices}-way {what}")


def spatial_device_list(
    spatial_devices: SpatialDevices, device: Optional[Device] = None,
) -> Optional[List[torch.device]]:
    """The spatial devices of `--spatial-devices`: None for an int S <= 1
    (no row sharding, as fgvc_tpu); for an int S > 1 the first S CUDA cards,
    or S copies of the CPU where `device` is 'cpu'; a sequence of devices as
    given."""
    return _axis_devices(spatial_devices, device, "row sharding")


def bank_device_list(
    bank_devices: SpatialDevices, device: Optional[Device] = None,
) -> Optional[List[torch.device]]:
    """The bank devices of `--bank-devices`, by spatial_device_list's
    rules."""
    return _axis_devices(bank_devices, device, "bank sharding")


def local_device_list(
    local_devices: LocalDevices, device: Optional[Device] = None,
    spatial_devices: SpatialDevices = None,
) -> Optional[List[Union[torch.device, List[torch.device]]]]:
    """The round-robin entries of `--local-devices`: None for an int G <= 1;
    for an int G > 1 the first G CUDA cards (G copies of the CPU where
    `device` is 'cpu'), or with an int `spatial_devices` S > 1 the first G * S
    cards in G groups of S (dp x sp); a sequence as given, each entry a device
    or a group (a sequence of devices)."""
    if local_devices is None:
        return None
    if not isinstance(local_devices, int):
        return [[torch.device(d) for d in e] if isinstance(e, (list, tuple))
                else torch.device(e) for e in local_devices]
    G = local_devices
    if G <= 1:
        return None
    S = spatial_devices if isinstance(spatial_devices, int) and spatial_devices > 1 else 1
    devs = _first_devices(G * S, device, f"{G} video groups × {S}-way row sharding")
    return devs if S == 1 else [devs[g * S:(g + 1) * S] for g in range(G)]


def build_tracker(
    test_cfg: TestConfig = DAVIS_TEST_CFG,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    spatial_devices: SpatialDevices = None,
    backbone: str = "resnet18_d1",
    bank_devices: SpatialDevices = None,
) -> Tracker:
    """Tracker over a zoo encoder (default: the paper's ResNet-18-d1), with
    weights from a reference ``.pth``, from the trained student of a port
    training checkpoint (a step_N directory or a latest/best pointer file;
    ResNet-18-d1 only), or seeded random weights.  Another `backbone` is
    built by models.zoo.make_eval_backbone, which also switches
    cfg.preprocess to what that encoder expects.  Runs on the CUDA card
    unless `device` names another; raises where there is no card and none
    was named.  With `spatial_devices` (spatial_device_list) or
    `bank_devices` (bank_device_list) it runs on the first of them."""
    spatial = spatial_device_list(spatial_devices, device)
    bank = bank_device_list(bank_devices, device)
    dev = resolve_device((spatial or bank or [device])[0])
    axes = dict(spatial_devices=spatial, bank_devices=bank)
    if backbone != "resnet18_d1":
        model, pre = make_eval_backbone(backbone, checkpoint, input_hw=test_cfg.input_size,
                                        seed=seed, device=dev)
        if test_cfg.preprocess != pre:
            test_cfg = dataclasses.replace(test_cfg, preprocess=pre)
        return Tracker(model, test_cfg, dev, **axes)
    model = resnet18_d1()
    if checkpoint is None:
        init_random(model, seed)
    elif checkpoint.endswith(".pth"):
        load_weights(model, load_reference_pth(checkpoint))
    else:
        # JAX orbax directories have no state.pt and are refused here
        load_weights(model, student_state_dict(checkpoint))
    return Tracker(model, test_cfg, dev, **axes)


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


def _my_videos(n: int, rank: int, world: int, max_videos=None) -> List[int]:
    """This rank's video ids: `max_videos` cuts the global list before it is
    dealt [rank::world], so the same videos are evaluated at any world
    size."""
    ids = list(range(n if max_videos is None else min(n, max_videos)))
    return ids[rank::world]


def _merge_shards(pairs):
    """Every process's (video id, payload) pairs, sorted by id, as (ids,
    payloads): each process then scores the whole set (the reference's
    collect_results); without it a multi-process run would report its own
    videos' metrics."""
    from fgvc_tpu_torch.parallel import dist

    pairs = sorted(dist.allgather_objects(pairs), key=lambda p: p[0])
    return [p[0] for p in pairs], [p[1] for p in pairs]


def device_trackers(tracker: Tracker, devices) -> List[Tracker]:
    """One tracker per round-robin entry, the single-process data-parallel
    fleet: an entry that is a device runs there; a group (a sequence of
    devices) runs spatial-parallel over it (dp x sp).  The trackers on one
    device share one backbone (the base tracker's where it lies)."""
    if tracker.spatial_devices is not None or tracker.bank_devices is not None:
        raise ValueError(
            "pass device GROUPS instead of building the base tracker on spatial or "
            "bank devices: the round-robin fleet gives each group entry its own"
        )
    replicas = {tracker.device: tracker.backbone}
    out = []
    for entry in devices:
        group = list(entry) if isinstance(entry, (list, tuple)) else None
        dev = full_device(group[0] if group else entry)
        if dev not in replicas:
            replicas[dev] = copy.deepcopy(tracker.backbone).to(dev)
        out.append(Tracker(replicas[dev], tracker.cfg, dev, spatial_devices=group))
    return out


def _round_robin(ids, devices, dispatch_fn, collect_fn) -> None:
    """The data-parallel in-flight window of every eval: video n is
    dispatched to entry n % D, and the oldest is collected once D videos are
    in flight, so every device has work queued while the host dispatches;
    the rest are collected at the end.  dispatch_fn(i, slot) -> (payload,
    disp); collect_fn(i, slot, payload, disp)."""
    from collections import deque

    D = len(devices)
    t0 = time.time()
    inflight: deque = deque()
    for n, i in enumerate(ids):
        payload, disp = dispatch_fn(i, n % D)
        inflight.append((i, n % D, payload, disp))
        while len(inflight) >= D:
            collect_fn(*inflight.popleft())
    while inflight:
        collect_fn(*inflight.popleft())
    print(f"[dp-eval] {len(ids)} videos over {D} devices in {time.time() - t0:.2f}s",
          flush=True)


def _eval_tapvid_multidevice(tracker: Tracker, dataset, ids, devices, output_dir=None) -> list:
    """(id, result) of each video, round-robin over `devices`; the first
    video collected is rendered under `output_dir` (_write_track_video)."""
    trackers = device_trackers(tracker, devices)
    results = []

    def dispatch(i, slot):
        sample = dataset[i]
        with annotate(f"propagate[{i}]"):
            return sample, trackers[slot].track_points_dispatch(
                sample["video"], sample["query_points"])

    def collect(i, slot, sample, disp):
        with annotate(f"collect[{i}]"):
            results.append((i, _pack_result(sample, trackers[slot].track_points_collect(disp))))
        if output_dir and len(results) == 1:
            _write_track_video(sample["video"], results[0][1]["trajectories_pred"], output_dir, i)

    _round_robin(ids, devices, dispatch, collect)
    return results


def _write_track_video(video, trajectories, output_dir: str, idx: int) -> None:
    """The trajectory render of the first video, as the JAX harness writes
    it: every point and its tail over the frames (utils/visualize.py) into
    output_dir/tracks_{idx:04d}.mp4.  Best-effort, so that it never changes
    a metric: an error is printed on one line instead of raised."""
    name = f"tracks_{idx:04d}.mp4"
    try:
        from fgvc_tpu_torch.utils.visualize import (draw_trajectory_tails, paint_point_track,
                                                    save_video)

        os.makedirs(output_dir, exist_ok=True)
        tracks = np.transpose(np.asarray(trajectories), (1, 0, 2))  # (P, T, 2)
        vid = draw_trajectory_tails(paint_point_track(np.asarray(video), tracks), tracks)
        save_video(vid, os.path.join(output_dir, name))
    except Exception as e:  # noqa: BLE001 -- the render must not end the evaluation
        print(f"[render] {name} not written: {type(e).__name__}: {e}", flush=True)


def _pack_result(sample, out):
    return {
        "trajectories_gt": sample["trajectories"],
        "visibilities_gt": sample["visibilities"],
        "trajectories_pred": out["trajectories"],
        "visibilities_pred": out["visibilities"],
        "query_points": sample["query_points"],
    }


def eval_tapvid(tracker: Union[Tracker, RaftTracker], dataset, max_videos=None,
                output_dir=None, rank=0, world=1, devices=None) -> Dict[str, float]:
    """Track this rank's videos of `dataset` (a TapVidDataset; _my_videos),
    merge every rank's results and score them; with `output_dir` the first
    video's tracks are also rendered there (_write_track_video).  A tracker without the
    dispatch/collect split (RaftTracker) tracks inside the collect span.
    `devices` (2 or more entries) round-robins the videos over them."""
    ids = _my_videos(len(dataset), rank, world, max_videos)
    if devices is not None and len(devices) > 1:
        results = _eval_tapvid_multidevice(tracker, dataset, ids, devices, output_dir)
    else:
        results = []
        split = hasattr(tracker, "track_points_dispatch")
        for i, sample in zip(ids, _read_ahead(dataset, ids)):
            t0 = time.time()
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
            results.append((i, _pack_result(sample, out)))
            if output_dir and len(results) == 1:
                _write_track_video(sample["video"], out["trajectories"], output_dir, i)
    idxs, results = _merge_shards(results)
    return dataset.evaluate(results, output_dir=output_dir, indices=idxs)


def _heatmap_eval_loop(tracker: Tracker, dataset, ids, devices=None) -> List[tuple]:
    """(id, (T, P, 2) coordinates at the reader's decode size) of the videos
    `ids` of a JHMDB or BADJA reader, one video read ahead, or round-robin
    over `devices` (2 or more entries)."""
    def dispatch(tr, i, sample):
        with annotate(f"propagate[{i}]"):
            return tr.track_heatmaps_dispatch(
                sample["video"], sample["ref_maps"], tuple(sample["original_shape"]))

    out = []
    if devices is not None and len(devices) > 1:
        trackers = device_trackers(tracker, devices)

        def collect(i, slot, _payload, disp):
            with annotate(f"collect[{i}]"):
                out.append((i, trackers[slot].track_heatmaps_collect(disp)))

        _round_robin(ids, devices, lambda i, slot: (None, dispatch(trackers[slot], i, dataset[i])),
                     collect)
        return sorted(out, key=lambda p: p[0])
    for i, sample in zip(ids, _read_ahead(dataset, ids)):
        t0 = time.time()
        disp = dispatch(tracker, i, sample)
        with annotate(f"collect[{i}]"):
            out.append((i, tracker.track_heatmaps_collect(disp)))
        print(f"[{i}] T={len(sample['video'])} P={sample['ref_maps'].shape[-1]}"
              f" {time.time() - t0:.2f}s", flush=True)
    return out


def eval_jhmdb(tracker: Tracker, dataset, max_videos=None, output_dir=None, rank=0, world=1,
               devices=None) -> Dict[str, float]:
    """Propagate this rank's videos' frame-0 joints (a JhmdbDataset), merge
    every rank's and score PCK at the original frame size."""
    ids = _my_videos(len(dataset), rank, world, max_videos)
    preds = [(i, np.transpose(c, (2, 1, 0)))  # (2, P, T)
             for i, c in _heatmap_eval_loop(tracker, dataset, ids, devices)]
    idxs, preds = _merge_shards(preds)
    return dataset.evaluate(preds, indices=idxs, output_dir=output_dir)


def eval_badja(tracker: Tracker, dataset, max_videos=None, output_dir=None, rank=0, world=1,
               devices=None) -> Dict[str, float]:
    """Propagate this rank's videos' frame-0 joints (a BadjaDataset), merge
    every rank's and score PCK at the reader's (320, 512)."""
    ids = _my_videos(len(dataset), rank, world, max_videos)
    idxs, preds = _merge_shards(_heatmap_eval_loop(tracker, dataset, ids, devices))
    return dataset.evaluate(preds, indices=idxs, output_dir=output_dir)


def eval_vos(tracker: Tracker, dataset, max_videos=None, output_dir=None, rank=0, world=1,
             devices=None) -> Dict[str, float]:
    """Propagate the first mask of this rank's videos of `dataset` (a
    DavisVosDataset, or anything with its __len__, __getitem__ and
    score_video), one video read ahead or round-robin over `devices`, score
    each video as it finishes, merge every rank's J&F stats (never the
    label maps, hundreds of MB a video) and pool them; appends them to
    output_dir/result.txt."""
    from fgvc_tpu_torch.core.metrics.vos import aggregate_jf
    from fgvc_tpu_torch.datasets.davis_vos import write_results

    ids = _my_videos(len(dataset), rank, world, max_videos)
    stats = []

    def dispatch(tr, i, sample):
        with annotate(f"propagate[{i}]"):
            return tr.track_masks_dispatch(sample["video"], sample["first_mask"],
                                           tuple(sample["original_shape"]),
                                           sample["num_objects"])

    def collect(tr, i, disp):
        with annotate(f"collect[{i}]"):
            s = dataset.score_video(i, tr.track_masks_collect(disp))
        if s is not None:
            stats.append((i, s))

    if devices is not None and len(devices) > 1:
        trackers = device_trackers(tracker, devices)
        _round_robin(ids, devices,
                     lambda i, slot: (None, dispatch(trackers[slot], i, dataset[i])),
                     lambda i, slot, _payload, disp: collect(trackers[slot], i, disp))
        stats.sort(key=lambda p: p[0])
    else:
        for i, sample in zip(ids, _read_ahead(dataset, ids)):
            t0 = time.time()
            collect(tracker, i, dispatch(tracker, i, sample))
            print(f"[{i}] T={len(sample['video'])} objects={sample['num_objects']}"
                  f" {time.time() - t0:.2f}s", flush=True)
    _, stats = _merge_shards(stats)
    results = aggregate_jf(stats)
    if output_dir:
        write_results(results, output_dir)
    return results


def _many(devices) -> bool:
    """Whether a device count or list asks for more than one device."""
    return devices is not None and (not isinstance(devices, int) or devices > 1)


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
    local_devices: LocalDevices = None,
    bank_devices: SpatialDevices = None,
) -> Dict[str, float]:
    """Mirror of `tools/test.py --task davis|kinetics|jhmdb|badja|vos
    [--query-mode strided] [--spatial-devices S] [--local-devices G]
    [--bank-devices N] [--backbone NAME] [--model vanilla|raft]`.
    query_mode 'strided' (TAP-Vid tasks only) queries every track every 5
    frames where it is visible.  JHMDB and BADJA read their lists under
    `list_path`, by default `data_root`.  VOS reads every video at 480 x 880
    and BADJA at 320 x 512 whatever cfg.input_size says, as the JAX harness
    does.  `backbone` names the encoder (models/zoo.py).  `model='raft'`
    (TAP-Vid tasks only, one device, `backbone` unread) builds
    build_raft_tracker(checkpoint) instead of the label-propagation
    tracker.

    The scaling axes (module docstring): `local_devices` (local_device_list)
    round-robins videos, composed with an int `spatial_devices` into G groups
    of S; `spatial_devices` alone shards each frame's rows; `bank_devices`
    (bank_device_list; attention_impl 'tiled') shards the bank's frames and
    excludes the other two.  In a multi-process run
    (parallel.dist.process_info) this process evaluates the videos
    [rank::world], every process scores the merged results, and only rank 0
    writes `output_dir`."""
    from fgvc_tpu_torch.parallel.dist import process_info

    if task not in TASK_CONFIGS:
        raise ValueError(f"unknown task {task!r}")
    if query_mode != "first" and task not in ("davis", "kinetics"):
        raise ValueError(
            f"--query-mode {query_mode!r} only applies to TAP-Vid point "
            f"tracking (davis/kinetics), not task {task!r}"
        )
    if model not in ("vanilla", "raft"):
        raise ValueError(f"model must be 'vanilla' or 'raft', got {model!r}")
    rank, world = process_info()
    # the report is written once (rank 0); every rank scores the merged results
    if rank != 0:
        output_dir = None
    cfg = test_cfg or TASK_CONFIGS[task]
    if model == "raft" and (_many(local_devices) or _many(spatial_devices)):
        raise ValueError(
            "--local-devices/--spatial-devices apply to the label-propagation tracker "
            "only (RaftTracker has no dispatch/collect split yet)"
        )
    if not isinstance(local_devices, (int, type(None))) and _many(spatial_devices):
        raise ValueError(
            "give local_devices as device groups (dp x sp), or local_devices and "
            "spatial_devices both as counts"
        )
    devices = local_device_list(local_devices, device, spatial_devices)
    banks = None
    if _many(bank_devices):
        if devices or _many(spatial_devices) or model == "raft":
            raise ValueError(
                "--bank-devices is exclusive with --local-devices/--spatial-devices and "
                "applies to the label-propagation tracker only"
            )
        banks = bank_device_list(bank_devices, device)
        if cfg.attention_impl != "tiled":
            # here, with the flag to flip, not from the Tracker (the task
            # presets say attention_impl='pallas')
            raise ValueError(
                "--bank-devices needs the tiled attention kernel; pass --attention-impl "
                "tiled (bank sharding is implemented for attention_impl='tiled', config "
                f"says {cfg.attention_impl!r})"
            )
    if model == "raft":
        if task not in ("davis", "kinetics"):
            raise ValueError("--model raft supports point-tracking tasks only")
        tracker = build_raft_tracker(checkpoint, seed=seed, device=device)
    elif devices:
        # the fleet (device_trackers) derives its trackers from one on the
        # first entry's device
        first = devices[0][0] if isinstance(devices[0], list) else devices[0]
        tracker = build_tracker(cfg, checkpoint, seed=seed, device=first, backbone=backbone)
    else:
        tracker = build_tracker(cfg, checkpoint, seed=seed, device=device,
                                spatial_devices=spatial_devices, backbone=backbone,
                                bank_devices=banks)
    kw = dict(output_dir=output_dir, rank=rank, world=world, devices=devices)
    if task in ("davis", "kinetics"):
        from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

        ds = TapVidDataset(data_root, subset_name=task, query_mode=query_mode,
                           input_size=cfg.input_size)
        return eval_tapvid(tracker, ds, max_videos, **kw)
    if task == "jhmdb":
        from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset

        ds = JhmdbDataset(data_root, list_path or data_root, input_size=cfg.input_size)
        return eval_jhmdb(tracker, ds, max_videos, **kw)
    if task == "badja":
        from fgvc_tpu_torch.datasets.badja import BadjaDataset

        ds = BadjaDataset(data_root, list_path or data_root)
        return eval_badja(tracker, ds, max_videos, **kw)
    from fgvc_tpu_torch.datasets import davis_vos

    ds = davis_vos.DavisVosDataset(data_root, split_list=list_path)
    return eval_vos(tracker, ds, max_videos, **kw)
