"""Multi-device and multi-process evaluation in the port against the JAX
harness: `parallel/dist.py`, `cli/launch.py` and run_task's `local_devices`.

- allgather_objects: an injected gather merges in rank order, one process
  passes through, and two real processes exchange unequal payloads over gloo
  (tests/test_dist_eval.py, tests/test_dist_allgather_real.py).
- initialize_from_flags: explicit flags win over the FGVC_* variables, no
  coordinator is a no-op.
- Two ranks in one process (an injected allgather, as tests/test_dist_eval.py
  does): the merged TAP-Vid, JHMDB and VOS metrics equal the single-process
  run's; `max_videos` cuts the global list.
- run_task with local_devices=2 (round-robin) and local_devices=2,
  spatial_devices=2 (dp x sp) on 'davis', 'jhmdb', 'badja' and 'vos' within
  1e-6 of JAX's run_task with the same flags (Pallas interpreted there).
- The device lists, the refusals with JAX's messages, the launcher's three
  behaviours (tests/test_launch.py), the CLI's flags.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data
from test_torch_port_eval_run_task import small_readers  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
SMALL = dict(neighbor_range=8, tile=8)
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# parallel/dist.py
# --------------------------------------------------------------------- #
def test_allgather_objects_merges_in_rank_order():
    from fgvc_tpu_torch.parallel.dist import allgather_objects

    shard0 = [(0, {"a": np.arange(3)}), (2, "x")]
    shard1 = [(1, 7.5)]
    merged = allgather_objects(
        shard0, _gather_bytes=lambda payload: [pickle.dumps(shard0), pickle.dumps(shard1)])
    assert [p[0] for p in merged] == [0, 2, 1]
    np.testing.assert_array_equal(merged[0][1]["a"], np.arange(3))
    objs = [(0, "a"), (1, "b")]
    assert allgather_objects(objs) == objs  # one process: passes through


_WORKER = r"""
import json, sys
sys.path.insert(0, %REPO%)
from fgvc_tpu_torch.parallel import dist

rank = int(sys.argv[1])
dist.initialize("localhost:%PORT%", 2, rank)
assert dist.process_info() == (rank, 2), dist.process_info()
# unequal payloads
shard = [(i, {"vid": i, "pts": list(range(i + 1))}) for i in range(rank, 5, 2)]
merged = sorted(dist.allgather_objects(shard), key=lambda p: p[0])
summaries = dist.allgather_summaries([{"rank": rank}])
dist.finalize()
print("RESULT" + json.dumps([[[i, d["vid"], len(d["pts"])] for i, d in merged], summaries]))
"""


def test_two_process_allgather_real():
    from fgvc_tpu_torch.cli.launch import _free_port

    script = _WORKER.replace("%PORT%", str(_free_port())).replace("%REPO%", repr(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, cwd=ROOT) for rank in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(out.decode())
    expect = [[[i, i, i + 1] for i in range(5)], [{"rank": 0}, {"rank": 1}]]
    for rank, out in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith("RESULT")]
        assert lines, f"rank {rank} printed no result: {out[-500:]}"
        assert json.loads(lines[0][len("RESULT"):]) == expect, rank


def test_initialize_from_flags(monkeypatch):
    from fgvc_tpu_torch.parallel import dist

    calls = []
    monkeypatch.setattr(dist, "initialize", lambda *a: calls.append(a))
    for k in ("FGVC_COORDINATOR", "FGVC_NUM_PROCESSES", "FGVC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize_from_flags() is False and not calls
    assert dist.process_info() == (0, 1)
    monkeypatch.setenv("FGVC_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("FGVC_NUM_PROCESSES", "4")
    monkeypatch.setenv("FGVC_PROCESS_ID", "3")
    assert dist.initialize_from_flags() is True
    assert dist.initialize_from_flags("host:5", num_processes=2, process_id=1) is True
    assert calls == [("localhost:1234", 4, 3), ("host:5", 2, 1)]
    monkeypatch.delenv("FGVC_NUM_PROCESSES")
    with pytest.raises(ValueError, match="number of processes"):
        dist.initialize_from_flags()


def test_max_videos_is_global_across_world_sizes():
    from fgvc_tpu_torch.apis.test import _my_videos

    assert _my_videos(10, 0, 1, max_videos=4) == [0, 1, 2, 3]
    assert _my_videos(10, 0, 2, max_videos=4) == [0, 2]
    assert _my_videos(10, 1, 2, max_videos=4) == [1, 3]
    assert _my_videos(3, 1, 2) == [1]


# --------------------------------------------------------------------- #
# two ranks in one process
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_trees")
    badja = data.make_badja(str(base / "badja"), seed=13)
    data.make_badja(badja, seed=15, animal="cat")
    return {
        "davis": data.make_tapvid(str(base / "davis"), seed=11, n_videos=3, T=8, size=(H, W)),
        "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=12),
        "badja": badja,
        "vos": data.make_davis(str(base / "vos"), seed=14),
        "pth": data.export_pth(base / "weights.pth", (H, W)),
    }


def _port_cfg(task, **kw):
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS

    return dataclasses.replace(TASK_CONFIGS[task], **SMALL, input_size=(H, W), **kw)


def _datasets(trees):
    from fgvc_tpu_torch.datasets.davis_vos import DavisVosDataset
    from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    return {
        "davis": TapVidDataset(trees["davis"], input_size=(H, W)),
        "jhmdb": JhmdbDataset(trees["jhmdb"], trees["jhmdb"], input_size=(H, W)),
        "vos": DavisVosDataset(trees["vos"]),
    }


@pytest.mark.parametrize("task", ["davis", "jhmdb", "vos"])
def test_two_rank_eval_matches_single_process(trees, small_readers, task,  # noqa: F811
                                              monkeypatch):
    """Rank 0 evaluates [0::2] and sees only its shard at the gather; rank 1
    evaluates [1::2] and gathers both: its metrics equal one process's over
    every video, each prediction scored against its own video."""
    from fgvc_tpu_torch.apis import test as api
    from fgvc_tpu_torch.parallel import dist

    evals = {"davis": api.eval_tapvid, "jhmdb": api.eval_jhmdb, "vos": api.eval_vos}
    tracker = api.build_tracker(_port_cfg(task), trees["pth"], device="cpu")
    ds = _datasets(trees)[task]
    ref = evals[task](tracker, ds)
    mailbox = []

    def fake_allgather(objs, _gather_bytes=None):
        mailbox.extend(objs)
        return list(mailbox)

    monkeypatch.setattr(dist, "allgather_objects", fake_allgather)
    evals[task](tracker, ds, rank=0, world=2)
    merged = evals[task](tracker, ds, rank=1, world=2)
    assert sorted(p[0] for p in mailbox) == list(range(len(ds)))
    assert merged == ref


def test_rank_other_than_zero_writes_no_output(trees, tmp_path, monkeypatch):
    from fgvc_tpu_torch.apis import test as api
    from fgvc_tpu_torch.parallel import dist

    kw = dict(checkpoint=trees["pth"], test_cfg=_port_cfg("davis"), device="cpu", max_videos=2)
    monkeypatch.setattr(dist, "process_info", lambda: (1, 2))
    monkeypatch.setattr(dist, "allgather_objects", lambda objs, _gather_bytes=None: list(objs))
    out = api.run_task("davis", trees["davis"], output_dir=str(tmp_path / "r1"), **kw)
    assert np.isfinite(out["average_pts_within_thresh"])
    assert not (tmp_path / "r1").exists()
    monkeypatch.setattr(dist, "process_info", lambda: (0, 1))
    api.run_task("davis", trees["davis"], output_dir=str(tmp_path / "r0"), **kw)
    assert (tmp_path / "r0").exists()


# --------------------------------------------------------------------- #
# run_task with local devices against the JAX harness
# --------------------------------------------------------------------- #
LOCAL_CASES = {
    # name: (local_devices, spatial_devices)
    "dp2": (2, None),
    "dp2_sp2": (2, 2),
}


@pytest.mark.parametrize("task", ["davis", "jhmdb", "badja", "vos"])
@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_run_task_local_devices_matches_jax(trees, small_readers, task, case,  # noqa: F811
                                            capsys):
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import run_task

    G, S = LOCAL_CASES[case]
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS[task], **SMALL, input_size=(H, W),
                                  frame_bucket=8, point_bucket=4, attention_impl="pallas")
    ref = jax_run_task(task, trees[task], checkpoint=trees["pth"], test_cfg=jax_cfg,
                       local_devices=G, spatial_devices=S)
    capsys.readouterr()
    out = run_task(task, trees[task], checkpoint=trees["pth"], test_cfg=_port_cfg(task),
                   device="cpu", local_devices=G, spatial_devices=S)
    assert "[dp-eval]" in capsys.readouterr().out
    key = {"jhmdb": "PCK@0.2", "badja": "PCK@0.2", "vos": "J&F-Mean"}.get(
        task, "average_pts_within_thresh")
    shared = sorted(set(ref) & set(out))
    assert key in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=k)


def test_device_trackers_share_a_backbone_per_device():
    from fgvc_tpu_torch.apis.test import build_tracker, device_trackers

    cpu = torch.device("cpu")
    base = build_tracker(_port_cfg("davis"), device="cpu")
    fleet = device_trackers(base, [cpu, [cpu, cpu], cpu])
    assert [t.spatial_devices for t in fleet] == [None, [cpu, cpu], None]
    assert all(t.backbone is base.backbone for t in fleet)
    with pytest.raises(ValueError, match="device GROUPS"):
        device_trackers(build_tracker(_port_cfg("davis"), device="cpu",
                                      spatial_devices=2), [cpu, cpu])


def test_device_lists(monkeypatch):
    """A count N > 1 takes the first N cards and refuses with JAX's message
    where there are fewer; N <= 1 is none; with 'cpu', N copies; a sequence
    as given (dp x sp: groups)."""
    from fgvc_tpu_torch.apis import test as api

    cuda = [torch.device("cuda", i) for i in range(4)]
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert api.local_device_list(3) == cuda[:3]
    assert api.local_device_list(2, spatial_devices=2) == [cuda[:2], cuda[2:]]
    assert api.local_device_list(1) is None and api.local_device_list(None) is None
    assert api.local_device_list(2, "cpu", spatial_devices=3) == [[cpu] * 3] * 2
    assert api.local_device_list(["cuda:0", ("cuda:0", "cuda:0")]) == [cuda[0], [cuda[0]] * 2]
    assert api.bank_device_list(2) == cuda[:2] and api.bank_device_list(1) is None
    assert api.bank_device_list(3, "cpu") == [cpu] * 3
    assert api.bank_device_list(["cuda:0"] * 2) == [cuda[0]] * 2
    with pytest.raises(ValueError, match="3 video groups × 2-way row sharding needs 6 local "
                                         "devices, have 4"):
        api.local_device_list(3, spatial_devices=2)
    with pytest.raises(ValueError, match="5-way bank sharding needs 5 local devices, have 4"):
        api.bank_device_list(5)


@pytest.mark.parametrize("kw,match", [
    (dict(model="raft", local_devices=2), "apply to the label-propagation tracker only"),
    (dict(local_devices=2, bank_devices=2), "--bank-devices is exclusive"),
    (dict(spatial_devices=2, bank_devices=2), "--bank-devices is exclusive"),
    (dict(model="raft", bank_devices=2), "--bank-devices is exclusive"),
    (dict(bank_devices=2), "--bank-devices needs the tiled attention kernel; pass "
                           "--attention-impl tiled"),
    (dict(local_devices=["cpu", "cpu"], spatial_devices=2), "device groups"),
])
def test_run_task_refusals(kw, match):
    from fgvc_tpu_torch.apis.test import run_task

    with pytest.raises(ValueError, match=match):
        run_task("davis", "/nonexistent", device="cpu", **kw)


# --------------------------------------------------------------------- #
# the launcher and the CLIs
# --------------------------------------------------------------------- #
def _launch(script, tmp_path, timeout):
    w = tmp_path / "w.py"
    w.write_text(script)
    return subprocess.run(
        [sys.executable, "-m", "fgvc_tpu_torch.cli.launch", "--nprocs", "2", "--",
         sys.executable, str(w)],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_launcher_gives_each_rank_its_coordinates(tmp_path):
    out = _launch("import os\n"
                  "env = [os.environ[k] for k in ('FGVC_PROCESS_ID', 'FGVC_NUM_PROCESSES',"
                  " 'FGVC_COORDINATOR')]\n"
                  f"with open(os.path.join({str(tmp_path)!r}, 'rank_' + env[0]), 'w') as f:\n"
                  "    f.write(' '.join(env))\n", tmp_path, 60)
    assert out.returncode == 0, out.stderr[-2000:]
    ranks = [(tmp_path / f"rank_{r}").read_text().split() for r in (0, 1)]
    assert [r[:2] for r in ranks] == [["0", "2"], ["1", "2"]]
    assert ranks[0][2] == ranks[1][2] and ranks[0][2].startswith("localhost:")


def test_launcher_ends_the_ranks_when_a_later_one_fails(tmp_path):
    t0 = time.monotonic()
    out = _launch("import os, sys, time\n"
                  "if os.environ['FGVC_PROCESS_ID'] == '1':\n"
                  "    sys.exit(5)\n"
                  "time.sleep(120)\n", tmp_path, 110)
    assert out.returncode == 5
    assert time.monotonic() - t0 < 60, "the launcher waited on rank 0"


def test_launcher_returns_the_failure(tmp_path):
    assert _launch("import sys; sys.exit(7)\n", tmp_path, 60).returncode == 7


def test_cli_flags_reach_run_task(monkeypatch, capsys):
    from fgvc_tpu_torch.apis import test as api
    from fgvc_tpu_torch.cli.test import main
    from fgvc_tpu_torch.parallel import dist

    seen = []
    monkeypatch.setattr(api, "run_task", lambda *a, **kw: seen.append(kw) or {"m": 1.0})
    inits = []
    monkeypatch.setattr(dist, "initialize", lambda *a: inits.append(a))
    main(["--task", "davis", "--data-root", "x", "--device", "cpu", "--local-devices", "2",
          "--spatial-devices", "3", "--bank-devices", "4", "--coordinator", "h:1",
          "--num-processes", "2", "--process-id", "1"])
    assert json.loads(capsys.readouterr().out) == {"m": 1.0}
    assert inits == [("h:1", 2, 1)]
    assert {k: seen[0][k] for k in ("local_devices", "spatial_devices", "bank_devices",
                                    "device")} == dict(local_devices=2, spatial_devices=3,
                                                       bank_devices=4, device="cpu")


def test_cli_rank_runs_on_its_card(monkeypatch, capsys):
    """Without device flags, rank r of a multi-process run takes cuda:{r % count}."""
    from fgvc_tpu_torch.apis import test as api
    from fgvc_tpu_torch.cli.test import main
    from fgvc_tpu_torch.parallel import dist

    seen = []
    monkeypatch.setattr(api, "run_task", lambda *a, **kw: seen.append(kw["device"]) or {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for rank, world in ((3, 4), (0, 1)):
        monkeypatch.setattr(dist, "process_info", lambda: (rank, world))
        main(["--task", "davis", "--data-root", "x"])
    assert seen == ["cuda:1", "cuda"]


def test_train_cli_refuses_a_launcher_rank(monkeypatch):
    """A cli.launch rank trains data-parallel now (tests/
    test_torch_port_ddp_train.py); one whose world the global batch does not
    divide is refused before it joins the group, and a coordinator without
    the rank's coordinates too."""
    from fgvc_tpu_torch.cli.train import main

    monkeypatch.setenv("FGVC_COORDINATOR", "localhost:1")
    monkeypatch.setenv("FGVC_NUM_PROCESSES", "3")
    monkeypatch.setenv("FGVC_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="does not divide over 3 processes"):
        main(["--synthetic", "--max-steps", "1", "--device", "cpu"])
    monkeypatch.delenv("FGVC_PROCESS_ID")
    with pytest.raises(ValueError, match="this process's id"):
        main(["--synthetic", "--max-steps", "1", "--device", "cpu", "--batch-size", "3"])


def test_training_backend_from_every_ranks_card(monkeypatch):
    """NCCL where no two ranks share a card, from the cards of every rank
    (host and card), not from this host's count: 2 hosts x 8 cards with 16
    ranks take NCCL; two ranks on a host with one card, or the CPU, gloo."""
    import types

    from fgvc_tpu_torch.parallel import dist

    def props(device):
        return types.SimpleNamespace(uuid=types.SimpleNamespace(bytes=bytes([device.index])))

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    for hosts, cards, expect in ((2, 8, "nccl"), (1, 1, "gloo"), (1, 2, "nccl")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        seen = []
        for rank in range(hosts * 2 if cards == 1 else hosts * cards):
            monkeypatch.setattr(dist.socket, "gethostname", lambda: f"node{rank // max(cards, 2)}")
            seen.append(dist.card_of(dist.rank_device("cuda", rank)))
        assert dist.training_backend(seen) == expect, (hosts, cards, seen)
    assert dist.card_of(dist.rank_device("cpu", 3)) == "cpu"
    assert dist.training_backend(["cpu", "cpu"]) == "gloo"


def test_ranks_exchange_their_cards_over_the_store():
    """Each rank sets its card in the group's TCP store and reads every
    rank's, so all pick one backend."""
    import threading

    from fgvc_tpu_torch.cli.launch import _free_port
    from fgvc_tpu_torch.parallel import dist

    port, out, stores = _free_port(), {}, {}

    def rank(r, card):
        # the stores outlive the threads: rank 0's serves the other's reads
        stores[r] = torch.distributed.TCPStore("localhost", port, 2, is_master=r == 0)
        out[r] = dist.exchange_cards(stores[r], 2, r, card)

    threads = [threading.Thread(target=rank, args=(r, c))
               for r, c in ((0, "nodeA/00"), (1, "nodeB/00"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert out == {0: ["nodeA/00", "nodeB/00"], 1: ["nodeA/00", "nodeB/00"]}
    assert dist.training_backend(out[0]) == "nccl"
