"""Data-parallel training of the port (parallel/dist.py, parallel/mesh.py,
models/resnet.py's global-batch BatchNorm, core/train.py's data-parallel
step, apis/train.py and cli/train.py under fgvc_tpu_torch.cli.launch)
against the JAX package, in two gloo processes on the CPU:

* k = 2 steps of two ranks, each on its half of a global batch of 4, from
  one flax init, against the JAX MixedTrainer's single-device step on the
  whole batch (which tests/test_train.py:77 holds to its 4-device mesh
  step): every loss of every step within 1e-5 relative; the student's
  parameters, both discriminators and the BatchNorm statistics after the
  steps within 1e-4 relative L2 (each module's leaves taken together), and
  both ranks' states equal bit for bit.  Plain, with fused_encoder (one
  union-batch BN update) and with remat (the recomputed forward issues the
  same collectives; JAX's remat is its plain step, tests/test_train.py:232).
  Both sides step with make_multi_optimizer's SGD on every module: Adam's
  first update is lr * sign(g), so the float32 rounding of any two
  implementations flips it on about 1e-4 of the weights (the one-process
  port against JAX: 4.3e-4 relative L2 after one step) and the next losses
  move by 2e-4; Adam on equal gradients is held to optax in
  tests/test_torch_port_train_ops.py.  fused_encoder's later losses hold
  1e-4 (the JAX fused gradient's known error, FUSED_LATER_LOSS_RTOL);
* batch_shuffle / batch_unshuffle over the two ranks with JAX's
  permutation: each rank's slice equal to the slice of JAX's shuffled
  global batch, and the round trip exact;
* a SIGTERM to cli.launch --nprocs 2 running cli.train: both ranks stop at
  one step boundary with a checkpoint, the restarted command resumes there
  and its log reads exactly 1..steps, and its losses equal an uninterrupted
  twin's bit for bit (tools/rehearse_train.py's contract); validation runs
  on process 0 alone at the last step and the best pointer is written.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(radius=2, crop_size=16, batch_size=4, matmul_precision="highest")
STEPS = 2
LOSS_RTOL, STATE_RTOL = 1e-5, 1e-4
# fused_encoder after the first step: the JAX step's gradient of that mode
# is off by up to 2.4e-3 on one leaf (tests/test_torch_port_train_step.py
# FUSED_GRAD_RTOL), which moves its second loss
# by 2e-5
FUSED_LATER_LOSS_RTOL = 1e-4
CASES = {"plain": {}, "fused_encoder": dict(fused_encoder=True), "remat": dict(remat=True)}
LR = 1e-3
MODULES = ("backbone", "corr_disc", "feat_disc")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, B=4, s=16):
    rng = np.random.default_rng(seed)
    return {
        "imgs": rng.standard_normal((B, 2, s, s, 3)).astype(np.float32),
        "imgs_sup": rng.standard_normal((B, 2, s, s, 3)).astype(np.float32),
        "flow": (rng.standard_normal((B, s, s, 2)) * 2).astype(np.float32),
        "flow_back": (rng.standard_normal((B, s, s, 2)) * 2).astype(np.float32),
    }


_WORKER = r'''
import sys
import numpy as np
import torch

torch.set_num_threads(2)
sys.path.insert(0, REPO)
rank, port, io = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from fgvc_tpu_torch.parallel import dist
dist.initialize(f"localhost:{port}", 2, rank, backend="gloo")
import fgvc_tpu_torch.core.train as core
from fgvc_tpu_torch.config import TrainConfig
from fgvc_tpu_torch.parallel.mesh import batch_shuffle, batch_unshuffle, shard_batch

spec = torch.load(io + "/in.pt", weights_only=False)
out = {}
for name, kw in spec["cases"].items():
    trainer = core.MixedTrainer(TrainConfig(**spec["kw"], **kw), device="cpu")
    sgd = lambda ps: torch.optim.SGD(ps, lr=spec["lr"])
    trainer.load_module_states(spec["states"]).reset_optimizer(
        10, overrides={m: sgd for m in spec["modules"]})
    for step, (batch, channels) in enumerate(zip(spec["batches"], spec["channels"])):
        core.draw_channels = lambda generator, c=channels: c  # JAX's draws
        losses = trainer.train_step(shard_batch(batch), core.step_generator(0, step))
        out[f"{name}/losses/{step}"] = {k: float(v) for k, v in losses.items()}
    out[f"{name}/state"] = {k: v for k, v in trainer.state_dict().items() if k != "opt_state"}
x = torch.from_numpy(spec["shuffle_x"])
local = shard_batch({"x": x})["x"]
shuffled, inv = batch_shuffle(local, perm=spec["perm"])
out["shuffled"] = shuffled
out["roundtrip"] = batch_unshuffle(shuffled, inv)
out["local"] = local
torch.save(out, f"{io}/out{rank}.pt")
dist.finalize()
'''


@pytest.fixture(scope="module")
def jax_and_ranks(tmp_path_factory):
    """The JAX single-device steps (losses, state) per case, and the two
    ranks' results from one pair of processes."""
    import jax
    import optax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import MixedTrainer as JaxTrainer
    from fgvc_tpu.core.train import make_multi_optimizer
    from fgvc_tpu.parallel.mesh import batch_shuffle as jax_shuffle
    from fgvc_tpu_torch.cli.launch import _free_port
    from fgvc_tpu_torch.models.weights import trainer_state_from_flax

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jt = JaxTrainer(JaxTrainConfig(**KW))
    state0, teacher = jax.jit(lambda k: jt.init(k, 10)[:2])(jax.random.PRNGKey(0))
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    channels = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        channels.append((int(jax.random.randint(k1, (), 1, 3)),
                         int(jax.random.randint(k2, (), 1, 3))))
    batches = [_batch(i) for i in range(STEPS)]
    reference = {}
    for fused in (False, True):
        jtc = JaxTrainer(JaxTrainConfig(**KW, fused_encoder=fused))
        tx = make_multi_optimizer(jtc.cfg, 10, {m: optax.sgd(LR) for m in MODULES})
        step_fn = jtc.make_train_step(tx)
        fresh = jax.tree_util.tree_map(jax.numpy.array, state0)  # the step donates its state
        state = fresh.replace(opt_state=tx.init(fresh.params))
        losses = []
        for batch, key in zip(batches, keys):
            state, l = step_fn(state, teacher, batch, key)
            losses.append({k: float(v) for k, v in l.items()})
        reference[fused] = {"losses": losses, "params": to_np(state.params),
                            "batch_stats": to_np(state.batch_stats)}
    shuffle_x = np.random.default_rng(9).standard_normal((4, 3, 5)).astype(np.float32)
    jax_shuffled, jax_inv = jax_shuffle(jax.numpy.asarray(shuffle_x), jax.random.PRNGKey(7))
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(7), 4))

    io = str(tmp_path_factory.mktemp("ddp"))
    states = trainer_state_from_flax(to_np(state0.params), to_np(state0.batch_stats),
                                     to_np(teacher))
    torch.save({"kw": KW, "cases": CASES, "states": states, "batches": batches,
                "channels": channels, "shuffle_x": shuffle_x, "perm": perm, "lr": LR,
                "modules": MODULES},
               os.path.join(io, "in.pt"))
    script = "REPO = " + repr(ROOT) + "\n" + _WORKER
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), port, io],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT)
             for r in (0, 1)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err.decode()[-3000:]
    ranks = [torch.load(os.path.join(io, f"out{r}.pt"), weights_only=False) for r in (0, 1)]
    return dict(reference=reference, ranks=ranks, jax_shuffled=np.asarray(jax_shuffled),
                jax_inv=np.asarray(jax_inv), shuffle_x=shuffle_x)


def _rel_l2(ours: dict, ref: dict) -> float:
    """||ours - ref|| / ||ref|| over the leaves of `ref` taken together."""
    a = {k: torch.as_tensor(ours[k]).double() for k in ref}
    b = {k: torch.as_tensor(np.asarray(ref[k])).double() for k in ref}
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in ref)
    den = sum(float((b[k] ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_the_jax_single_device_steps(jax_and_ranks, case):
    from fgvc_tpu_torch.models.weights import (
        discriminator_state_dict_from_flax,
        state_dict_from_flax,
    )

    ref = jax_and_ranks["reference"][case == "fused_encoder"]
    r0, r1 = jax_and_ranks["ranks"]
    for step in range(STEPS):
        got = r0[f"{case}/losses/{step}"]
        assert got == r1[f"{case}/losses/{step}"], step
        rtol = FUSED_LATER_LOSS_RTOL if case == "fused_encoder" and step > 0 else LOSS_RTOL
        for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss"):
            assert got[k] == pytest.approx(ref["losses"][step][k], rel=rtol), (step, k)
    s0, s1 = r0[f"{case}/state"], r1[f"{case}/state"]
    for part in ("params", "batch_stats"):
        flat0 = s0[part] if part == "batch_stats" else {
            f"{m}.{k}": v for m, sd in s0[part].items() for k, v in sd.items()}
        flat1 = s1[part] if part == "batch_stats" else {
            f"{m}.{k}": v for m, sd in s1[part].items() for k, v in sd.items()}
        for k in flat0:
            assert torch.equal(flat0[k], flat1[k]), (part, k)
    student = state_dict_from_flax({"params": ref["params"]["backbone"],
                                    "batch_stats": ref["batch_stats"]})
    buffers = {k for k in s0["batch_stats"] if not k.endswith("num_batches_tracked")}
    params = {k: v for k, v in student.items() if k in s0["params"]["backbone"]}
    assert _rel_l2(s0["params"]["backbone"], params) < STATE_RTOL
    stats = {k: student[k] for k in buffers if not k.startswith("layer4")}
    assert _rel_l2(s0["batch_stats"], stats) < STATE_RTOL
    layer4 = {k: student[k] for k in buffers if k.startswith("layer4")}
    assert _rel_l2(s0["batch_stats"], layer4) < STATE_RTOL
    for disc in ("corr_disc", "feat_disc"):
        want = discriminator_state_dict_from_flax(ref["params"][disc])
        assert _rel_l2(s0["params"][disc], want) < STATE_RTOL, disc


def test_batch_shuffle_over_two_ranks_matches_jax(jax_and_ranks):
    """Each rank's slice of the shuffled global batch is the slice of JAX's
    batch_shuffle(x, key) with the same permutation; batch_unshuffle gives
    the rank's original slice back exactly."""
    for rank, out in enumerate(jax_and_ranks["ranks"]):
        lo, hi = 2 * rank, 2 * rank + 2
        np.testing.assert_array_equal(out["local"].numpy(), jax_and_ranks["shuffle_x"][lo:hi])
        np.testing.assert_array_equal(out["shuffled"].numpy(),
                                      jax_and_ranks["jax_shuffled"][lo:hi])
        assert torch.equal(out["roundtrip"], out["local"])


def test_single_process_shuffle_is_a_gather_as_in_jax():
    import jax

    from fgvc_tpu.parallel.mesh import batch_shuffle as jax_shuffle
    from fgvc_tpu.parallel.mesh import batch_unshuffle as jax_unshuffle
    from fgvc_tpu_torch.parallel.mesh import batch_shuffle, batch_unshuffle, local_slice

    x = np.arange(30, dtype=np.float32).reshape(6, 5)
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, 6))
    shuffled, inv = batch_shuffle(torch.from_numpy(x), perm=perm)
    js, jinv = jax_shuffle(jax.numpy.asarray(x), key)
    np.testing.assert_array_equal(shuffled.numpy(), np.asarray(js))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(batch_unshuffle(shuffled, inv).numpy(),
                                  np.asarray(jax_unshuffle(js, jinv)))
    g = torch.Generator().manual_seed(0)
    s2, inv2 = batch_shuffle(torch.from_numpy(x), generator=g)
    assert torch.equal(batch_unshuffle(s2, inv2), torch.from_numpy(x))
    assert local_slice(x, 1, 3).tolist() == x[2:4].tolist()
    assert local_slice(x).tolist() == x.tolist()  # one process holds the whole batch


# ---------------------------------------------------------------------- #
# SIGTERM to the launcher, resume, twin
# ---------------------------------------------------------------------- #
def _launch_train(work, steps):
    cmd = [sys.executable, "-m", "fgvc_tpu_torch.cli.launch", "--nprocs", "2", "--",
           sys.executable, "-m", "fgvc_tpu_torch.cli.train", "--synthetic", "--device", "cpu",
           "--crop", "16", "--radius", "2", "--batch-size", "4", "--precision", "highest",
           "--max-steps", str(steps), "--ckpt-interval", str(steps), "--log-interval", "1",
           "--synthetic-val", "--val-interval", str(steps), "--work-dir", work]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT,
                            env=env, text=True)


def _log(work):
    """The complete lines of a run's log (the last may be in flight while
    the run writes it)."""
    path = os.path.join(work, "train_log.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def test_sigterm_to_the_launcher_stops_both_ranks_and_resume_is_step_exact(tmp_path):
    steps = 8
    main, twin = str(tmp_path / "main"), str(tmp_path / "twin")
    twin_run = _launch_train(twin, steps)  # the uninterrupted twin, alongside
    p = _launch_train(main, steps)
    t0 = time.monotonic()
    while len(_log(main)) < 2 and p.poll() is None and time.monotonic() - t0 < 120:
        time.sleep(0.02)
    p.send_signal(signal.SIGTERM)
    out1, _ = p.communicate(timeout=120)
    assert p.returncode == 0, out1[-3000:]
    # the ranks share one pipe: one rank's line may land inside the other's
    stops = [int(k) for k in re.findall(r"preempted: stopping at step (\d+)", out1)]
    assert len(stops) == 2 and stops[0] == stops[1], out1[-2000:]
    k = stops[0]
    assert 2 <= k < steps, k
    assert "backend gloo" in out1
    assert os.path.exists(os.path.join(main, f"step_{k}", "state.pt"))

    p = _launch_train(main, steps)
    out2, _ = p.communicate(timeout=180)
    assert p.returncode == 0, out2[-3000:]
    assert f"resumed from {os.path.join(main, f'step_{k}')} (step {k})" in out2
    log = [r for r in _log(main) if "loss" in r]
    assert [r["step"] for r in log] == list(range(1, steps + 1))
    # process 0 validated alone and every rank agreed on the best step
    assert [r["step"] for r in _log(main) if "val" in r] == [steps]
    assert open(os.path.join(main, "best")).read() == f"step_{steps}"

    out3, _ = twin_run.communicate(timeout=180)
    assert twin_run.returncode == 0, out3[-3000:]
    want = {r["step"]: r for r in _log(twin) if "loss" in r}
    for r in log:
        for key in ("l1_loss", "sup_loss", "corr_da_loss", "loss"):
            assert r[key] == want[r["step"]][key], (r["step"], key)
