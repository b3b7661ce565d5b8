"""The port's harness on the tasks of this slice against the JAX harness:
``run_task`` for 'kinetics' (strided), 'davis' with query_mode 'strided',
'jhmdb', 'badja' and 'vos', on the CPU (the JAX Pallas kernel interpreted),
over tiny trees in each dataset's layout (tests/test_torch_port_eval_data.py) and
the same ResNet-18-d1 weights exported as the reference ``.pth`` both
harnesses read.  Small windows (neighbor_range 8, tile 8); BADJA's fixed
320 x 512 and VOS's 480 x 880 are cut to 32 x 48 in both readers.  Every
shared metric agrees within 1e-6.  Then spatial-parallel JHMDB (S = 2 row
blocks on the CPU) against the unsharded run, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

H = W = 32
SMALL = dict(neighbor_range=8, tile=8)
METRIC_TOL = 1e-6
# task -> (tree, query_mode, input size of the configuration)
CASES = {
    "kinetics-strided": ("kinetics", "strided", (H, W)),
    "davis-strided": ("davis", "strided", (H, W)),
    "jhmdb": ("jhmdb", "first", (H, W)),
    "badja": ("badja", "first", (H, W)),
    "vos": ("vos", "first", (H, W)),
}
SMALL_READER = (32, 48)  # BADJA and VOS readers, both packages


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU,
    and torch's default of one thread per core in each worker
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_run_task")
    return {
        "kinetics": data.make_tapvid(str(base / "kinetics"), seed=10, T=11, size=(40, 56),
                                     jpeg=True, nested=True),
        "davis": data.make_tapvid(str(base / "davis"), seed=11, T=8, size=(H, W)),
        "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=12),
        "badja": data.make_badja(str(base / "badja"), seed=13),
        "vos": data.make_davis(str(base / "vos"), seed=14),
        "pth": data.export_pth(base / "weights.pth", (H, W)),
    }


@pytest.fixture
def small_readers(monkeypatch):
    """BADJA's (320, 512) and VOS's (480, 880) cut to 32 x 48 in both
    packages' readers (their run_task takes no size for them)."""
    import fgvc_tpu.datasets.badja as jax_badja
    import fgvc_tpu.datasets.davis_vos as jax_davis
    import fgvc_tpu_torch.datasets.badja as badja
    import fgvc_tpu_torch.datasets.davis_vos as davis

    for mod in (jax_badja, badja):
        class SmallBadja(mod.BadjaDataset):
            def __init__(self, root, list_path):
                super().__init__(root, list_path, size=SMALL_READER)

        monkeypatch.setattr(mod, "BadjaDataset", SmallBadja)
    for mod in (jax_davis, davis):
        class SmallDavis(mod.DavisVosDataset):
            def __init__(self, root, split_list=None):
                super().__init__(root, split_list=split_list, input_size=SMALL_READER)

        monkeypatch.setattr(mod, "DavisVosDataset", SmallDavis)


def _port_cfg(task, size):
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS

    return dataclasses.replace(TASK_CONFIGS[task], **SMALL, input_size=size)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_task_matches_jax(trees, small_readers, case):
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import run_task

    task, query_mode, size = CASES[case]
    root, pth = trees[task], trees["pth"]
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS[task], **SMALL, input_size=size,
                                  frame_bucket=8, point_bucket=4, attention_impl="pallas")
    ref = jax_run_task(task, root, checkpoint=pth, test_cfg=jax_cfg, query_mode=query_mode)
    out = run_task(task, root, checkpoint=pth, test_cfg=_port_cfg(task, size), device="cpu",
                   query_mode=query_mode)
    shared = sorted(set(ref) & set(out))
    key = {"jhmdb": "PCK@0.2", "badja": "PCK@0.2", "vos": "J&F-Mean"}.get(
        task, "average_pts_within_thresh")
    assert key in shared, (key, sorted(out), sorted(ref))
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=k)


def test_run_task_jhmdb_row_blocks_equal_unsharded(trees):
    """run_task('jhmdb', spatial_devices=2) on the CPU (two row blocks, K4's
    path) gives the unsharded run's PCK exactly."""
    from fgvc_tpu_torch.apis.test import run_task

    kw = dict(checkpoint=trees["pth"], test_cfg=_port_cfg("jhmdb", (H, W)), device="cpu")
    single = run_task("jhmdb", trees["jhmdb"], **kw)
    assert run_task("jhmdb", trees["jhmdb"], spatial_devices=2, **kw) == single
