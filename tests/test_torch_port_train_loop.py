"""The port's training loop, checkpoints and CLI on the CPU: step-exact
resume (4 steps against 2 + resume + 2, torch.equal), best-checkpoint
tracking, SIGTERM, the teacher from a checkpoint, EMA, the CLI with
--device cpu and its refusals, and fgvc_tpu_torch.cli.test evaluating what
the trainer wrote."""

import json
import os
import signal

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU,
    and torch's default of one thread per core in each worker
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KW = dict(radius=2, crop_size=16, batch_size=8)


def _batch(i, B=8, s=16):
    r = np.random.default_rng(100 + i)
    return {
        "imgs": r.standard_normal((B, 2, s, s, 3)).astype(np.float32),
        "imgs_sup": r.standard_normal((B, 2, s, s, 3)).astype(np.float32),
        "flow": r.standard_normal((B, s, s, 2)).astype(np.float32),
        "flow_back": r.standard_normal((B, s, s, 2)).astype(np.float32),
    }


def _state(trainer):
    """Every tensor of the trainer's checkpoint payload, by name."""
    out = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = obj

    walk("", trainer.state_dict())
    return out


def _train(cfg, batches, work_dir, **kw):
    from fgvc_tpu_torch.apis.train import train_model

    kw = {"steps_per_epoch": 10, "log_interval": 1000, "device": "cpu", **kw}
    return train_model(cfg, batches, str(work_dir), **kw)


def test_resume_is_step_exact(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, and 2 more resumed
    from it: parameters, BN statistics, Adam moments, steps and teacher
    equal bit for bit (per-step generators from (seed + 1, step))."""
    from fgvc_tpu_torch.config import TrainConfig

    cfg = TrainConfig(**KW)
    seq = [_batch(i) for i in range(4)]
    a = _train(cfg, list(seq), tmp_path / "a", max_steps=4, ckpt_interval=1000, resume=False)
    _train(cfg, seq[:2], tmp_path / "b", max_steps=2, ckpt_interval=2, resume=False)
    b = _train(cfg, seq[2:], tmp_path / "b", max_steps=4, ckpt_interval=1000, resume=True)
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys() and a.step == b.step == 4
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb[k]), k
        else:
            assert v == sb[k], k
    assert sorted(p for p in os.listdir(tmp_path / "b") if p.startswith("step_")) == [
        "step_2", "step_4"]


def test_best_checkpoint_tracking_and_log(tmp_path):
    """A val_fn's metric picks the best checkpoint (`best` pointer and
    best.json); train_log.jsonl carries the losses with steps_per_sec."""
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.checkpoint import best_checkpoint, latest_checkpoint

    values = iter([0.2, 0.5, 0.3])
    work = tmp_path / "run"
    _train(TrainConfig(**KW), [_batch(i) for i in range(3)], work, max_steps=3,
           log_interval=1, val_fn=lambda trainer: {"average_pts_within_thresh": next(values)},
           val_interval=1)
    assert best_checkpoint(str(work)).endswith("step_2")
    assert latest_checkpoint(str(work)).endswith("step_3")
    with open(work / "best.json") as f:
        assert json.load(f) == {"step": 2, "metric": "average_pts_within_thresh", "value": 0.5}
    with open(work / "train_log.jsonl") as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines if "val" not in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(r["steps_per_sec"] > 0 and np.isfinite(r["loss"]) for r in steps)
    assert [r["val"]["average_pts_within_thresh"] for r in lines if "val" in r] == [0.2, 0.5, 0.3]


def test_sigterm_checkpoints_and_stops(tmp_path):
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.checkpoint import latest_checkpoint

    def batches():
        for i in range(4):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield _batch(i)

    trainer = _train(TrainConfig(**KW), batches(), tmp_path, max_steps=4, ckpt_interval=1000)
    assert 1 <= trainer.step < 4
    assert latest_checkpoint(str(tmp_path)).endswith(f"step_{trainer.step}")
    assert signal.getsignal(signal.SIGTERM) is not None


def test_check_numerics_raises_in_the_loop(tmp_path):
    from fgvc_tpu_torch.config import TrainConfig

    bad = _batch(0)
    bad["imgs_sup"][0, 0, 0, 0, 0] = np.inf
    with pytest.raises(FloatingPointError, match="step 1"):
        _train(TrainConfig(**KW, check_numerics=True), [bad], tmp_path, max_steps=1)


def test_teacher_from_a_checkpoint_and_ema(tmp_path):
    """--teacher WORK_DIR/latest: the trained student of that run becomes the
    frozen teacher; teacher_ema mixes the student in after each step."""
    from fgvc_tpu_torch.apis.train import ema_update
    from fgvc_tpu_torch.config import TrainConfig

    cfg = TrainConfig(**KW)
    first = _train(cfg, [_batch(0)], tmp_path / "first", max_steps=1)
    second = _train(cfg, [], tmp_path / "second", max_steps=1,
                    teacher_init=str(tmp_path / "first" / "latest"))
    for (k, v), w in zip(first.backbone.state_dict().items(), second.teacher.state_dict().values()):
        assert torch.equal(v, w), k
    t = [p.detach().clone() for p in second.teacher.parameters()]
    ema_update(second.teacher, second.backbone, 0.75)
    for p0, p, s in zip(t, second.teacher.parameters(), second.backbone.parameters()):
        torch.testing.assert_close(p, 0.75 * p0 + 0.25 * s, rtol=1e-6, atol=1e-7)


def test_cli_trains_on_cpu_and_cli_test_reads_the_checkpoint(tmp_path, capsys):
    """python -m fgvc_tpu_torch.cli.train --device cpu on structured data
    with the synthetic validation (the port's Tracker on the student's
    weights), then python -m fgvc_tpu_torch.cli.test --checkpoint
    WORK_DIR/latest --config (the validation's settings) --input-size 64 on
    those pickles: the validation's metrics."""
    from fgvc_tpu_torch.cli import test as cli_test
    from fgvc_tpu_torch.cli import train as cli_train

    work = str(tmp_path / "run")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"radius": 2, "matmul_precision": "highest"}))
    assert cli_train.main([
        "--synthetic", "--synthetic-mode", "structured", "--crop", "32", "--batch-size", "2",
        "--config", str(cfg_file), "--precision", "high", "--max-steps", "2",
        "--log-interval", "1", "--synthetic-val", "--val-interval", "2",
        "--work-dir", work, "--device", "cpu"]) == 0
    with open(os.path.join(work, "train_log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    val = [r["val"] for r in lines if "val" in r]
    assert len(val) == 1 and np.isfinite(val[0]["average_pts_within_thresh"])
    assert [r["step"] for r in lines if "loss" in r] == [1, 2]
    payload = torch.load(os.path.join(work, "step_2", "state.pt"), weights_only=True)
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 2
    assert payload["params"]["corr_disc"]["fc1.weight"].shape == (12, 25)  # radius 2 kept
    capsys.readouterr()
    val_cfg = tmp_path / "val.json"
    val_cfg.write_text(json.dumps({"neighbor_range": 6, "tile": 8}))
    cli_test.main(["--task", "davis", "--data-root", os.path.join(work, "synth_val"),
                   "--checkpoint", os.path.join(work, "latest"), "--config", str(val_cfg),
                   "--input-size", "64", "--device", "cpu", "--output-dir", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    metrics = json.loads(out[out.index("{"):])
    assert metrics["average_pts_within_thresh"] == pytest.approx(
        val[0]["average_pts_within_thresh"], abs=1e-6)
    assert metrics["average_jaccard"] == pytest.approx(val[0]["average_jaccard"], abs=1e-6)


def test_cli_refusals(tmp_path, monkeypatch):
    from fgvc_tpu_torch.cli import train as cli_train

    base = ["--synthetic", "--crop", "16", "--radius", "2", "--max-steps", "1",
            "--work-dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(base)
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit):  # real data needs both trees
        cli_train.main(["--ytv-root", "ytv", "--device", "cpu", "--work-dir", str(tmp_path)])
    # several processes train now; a global batch that does not divide over
    # them is refused before any group is joined
    with pytest.raises(ValueError, match="does not divide over 3 processes"):
        cli_train.main(base + ["--coordinator", "localhost:1234", "--num-processes", "3",
                               "--process-id", "0", "--batch-size", "4", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_train.main(base + ["--platform", "tpu"])
    # bfloat16 trains now (tests/test_torch_port_train_bf16.py); float16 is
    # refused, as in JAX
    with pytest.raises(ValueError, match="float16"):
        cfg = tmp_path / "fp16.json"
        cfg.write_text(json.dumps({"compute_dtype": "float16"}))
        cli_train.main(base + ["--config", str(cfg), "--device", "cpu"])


def test_build_tracker_refuses_what_is_no_checkpoint(tmp_path):
    from fgvc_tpu_torch.apis.test import build_tracker

    (tmp_path / "latest").write_text("step_9")
    with pytest.raises(FileNotFoundError, match="points at no checkpoint"):
        build_tracker(checkpoint=str(tmp_path / "latest"), device="cpu")
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(FileNotFoundError, match="not a training checkpoint"):
        build_tracker(checkpoint=str(tmp_path / "orbax_dir"), device="cpu")
