"""Evaluation harness of the port (fgvc_tpu/apis/test.py): TAP-Vid-DAVIS
point tracking and DAVIS-2017 VOS.

    run_task('davis', data_root, checkpoint=None, device=None, spatial_devices=None)
    run_task('vos', data_root, list_path=None, test_cfg=None, device=None)

builds the ResNet-18-d1 tracker on the card (or on the device the caller
names), evaluates every video of `data_root` and returns the task's metrics
(TAP-Vid's, or DAVIS J&F).  `spatial_devices` S > 1 shards each frame's query
rows over the first S cards (spatial-parallel propagation); a list of devices
is taken as given, so one card listed S times runs S row blocks on it.

Both evals read one video ahead on a worker thread and name their steps for
``--profile`` traces as the JAX harness does: ``propagate[i]`` around video
i's tracking and ``collect[i]`` around reading (and, for VOS, scoring) its
results.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import torch

from fgvc_tpu_torch.config import DAVIS_TEST_CFG, TestConfig
from fgvc_tpu_torch.core.checkpoint import student_state_dict
from fgvc_tpu_torch.device import resolve_device
from fgvc_tpu_torch.models.resnet import init_random, resnet18_d1
from fgvc_tpu_torch.models.tracker import Tracker
from fgvc_tpu_torch.models.weights import load_reference_pth, load_weights
from fgvc_tpu_torch.utils.profiler import annotate

TASK_CONFIGS: Dict[str, TestConfig] = {"davis": DAVIS_TEST_CFG, "vos": DAVIS_TEST_CFG}

# tasks of fgvc_tpu's CLI that later slices of ROADMAP.md port
_LATER = {
    "kinetics": "slice 2 (Kinetics and multi-GPU eval)",
    "jhmdb": "slice 4 (JHMDB and BADJA)",
    "badja": "slice 4 (JHMDB and BADJA)",
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
) -> Tracker:
    """ResNet-18-d1 tracker with weights from a reference ``.pth``, from the
    trained student of a port training checkpoint (a step_N directory or a
    latest/best pointer file), or seeded random weights.  Runs on the CUDA
    card unless `device` names another; raises where there is no card and
    none was named.  With `spatial_devices` (spatial_device_list) it runs on
    the first of them."""
    spatial = spatial_device_list(spatial_devices, device)
    dev = resolve_device(device if spatial is None else spatial[0])
    model = resnet18_d1()
    if checkpoint is None:
        init_random(model, seed)
    elif checkpoint.endswith(".pth"):
        load_weights(model, load_reference_pth(checkpoint))
    else:
        # JAX orbax directories have no state.pt and are refused here
        load_weights(model, student_state_dict(checkpoint))
    return Tracker(model, test_cfg, dev, spatial_devices=spatial)


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


def eval_tapvid(tracker: Tracker, dataset, max_videos=None, output_dir=None) -> Dict[str, float]:
    """Track every video of `dataset` (a TapVidDataset) and score the
    results."""
    n = len(dataset) if max_videos is None else min(len(dataset), max_videos)
    ids = list(range(n))
    results = []
    for i, sample in zip(ids, _read_ahead(dataset, ids)):
        t0 = time.time()
        with annotate(f"propagate[{i}]"):
            disp = tracker.track_points_dispatch(sample["video"], sample["query_points"])
        with annotate(f"collect[{i}]"):
            out = tracker.track_points_collect(disp)
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
) -> Dict[str, float]:
    """Mirror of `tools/test.py --task davis|vos [--spatial-devices S]`.
    VOS reads every video at 480 x 880 whatever cfg.input_size says, as the
    JAX harness does."""
    if task in _LATER:
        raise NotImplementedError(
            f"task {task!r} is not ported to fgvc_tpu_torch yet; it comes "
            f"with {_LATER[task]}"
        )
    if task not in TASK_CONFIGS:
        raise ValueError(f"unknown task {task!r}")
    cfg = test_cfg or TASK_CONFIGS[task]
    tracker = build_tracker(cfg, checkpoint, seed=seed, device=device,
                            spatial_devices=spatial_devices)
    if task == "vos":
        from fgvc_tpu_torch.datasets import davis_vos

        ds = davis_vos.DavisVosDataset(data_root, split_list=list_path)
        return eval_vos(tracker, ds, max_videos, output_dir=output_dir)
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    ds = TapVidDataset(data_root, subset_name=task, input_size=cfg.input_size)
    return eval_tapvid(tracker, ds, max_videos, output_dir=output_dir)
