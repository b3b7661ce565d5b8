"""K6: the port's tensor-core / SIMT overlap microbenchmark
(fgvc_tpu_torch/ops/cuda/mxu_vpu_overlap.py) against the JAX tool's
``make(kind)`` (tools/bench/mxu_vpu_overlap.py), whose Pallas kernel runs here
in interpret mode, at the tool's own shapes.

The tool is loaded from its file with its ``pl`` replaced by a namespace whose
``pallas_call`` is bound with ``interpret=True``; it sets
``jax_compilation_cache_dir`` when imported, which is put back.  In interpret
mode the scratch columns that 'vpu' never writes hold NaN, so every row of
'vpu' is 10 * FK.

Tolerances: 'mxu' within 1e-3 (|out| is up to about 60 and both sides sum
float32 products in another order); 'mixed' - 'mxu' is the integer count sum,
equal on both sides; 'vpu' exact.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MXU_TOL = 1e-3


@pytest.fixture(scope="module")
def tool():
    import functools

    import jax
    from jax.experimental import pallas

    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "mxu_vpu_overlap_tool", os.path.join(ROOT, "tools", "bench", "mxu_vpu_overlap.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    mod.pl = types.SimpleNamespace(
        **{n: getattr(pallas, n) for n in dir(pallas) if not n.startswith("_")})
    mod.pl.pallas_call = functools.partial(pallas.pallas_call, interpret=True)
    return mod


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((k6.S, k6.C)).astype(np.float32)
    k = rng.standard_normal((k6.T, k6.FK, k6.C)).astype(np.float32)
    return q, k


@pytest.fixture(scope="module")
def results(tool, inputs):
    import jax.numpy as jnp

    q, k = inputs
    ref = {kind: np.asarray(tool.make(kind)(jnp.asarray(q), jnp.asarray(k))) for kind in k6.KINDS}
    out = {kind: k6.overlap(kind, torch.from_numpy(q), torch.from_numpy(k)).numpy()
           for kind in k6.KINDS}
    return out, ref


def test_constants_match_the_tool(tool):
    assert (k6.S, k6.FK, k6.C, k6.T, k6.R) == (tool.S, tool.FK, tool.C, tool.T, tool.R)


@pytest.mark.parametrize("kind", k6.KINDS)
def test_overlap_plain_matches_jax(results, kind):
    out, ref = results
    assert out[kind].shape == ref[kind].shape == (k6.S, 128)
    if kind == "mxu":
        np.testing.assert_allclose(out[kind], ref[kind], rtol=0, atol=MXU_TOL)
    elif kind == "vpu":
        np.testing.assert_array_equal(ref[kind], 10.0 * k6.FK)
        np.testing.assert_array_equal(out[kind], ref[kind])
    else:
        counts = [np.round(r["mixed"] - r["mxu"]) for r in (out, ref)]
        for r, c in zip((out, ref), counts):
            np.testing.assert_allclose(r["mixed"] - r["mxu"], c, atol=1e-4)
        np.testing.assert_array_equal(counts[0], counts[1])
        np.testing.assert_array_equal(counts[0], 66.0)  # 0 + 1 + ... + 11


def test_overlap_quality_normalisation():
    q = k6.overlap_quality({"mxu": 1.0, "vpu": 2.0, "mixed": 1.0})
    assert q["vpu_frac"] == pytest.approx(12 / 66)
    assert q["expected_serial"] == pytest.approx(1.0 + 2.0 * 12 / 66)
    assert q["overlap"] == pytest.approx(1.0)


def test_overlap_checks():
    q, k = torch.zeros(k6.S, k6.C), torch.zeros(k6.T, k6.FK, k6.C)
    with pytest.raises(ValueError, match="kind"):
        k6.overlap("both", q, k)
    with pytest.raises(ValueError, match="q must be"):
        k6.overlap("mxu", q[:8], k)
    with pytest.raises(TypeError, match="float32"):
        k6.overlap("mxu", q.double(), k)
    k6.launches["mxu"] = 2
    k6.reset_launches()
    assert k6.launches == dict.fromkeys(k6.KINDS, 0)


@pytest.mark.cuda
def test_overlap_kernel_matches_plain_on_card(inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    q, k = (torch.from_numpy(x).cuda() for x in inputs)
    k6.reset_launches()
    out = {kind: k6.overlap(kind, q, k).cpu().numpy() for kind in k6.KINDS}
    ref = {kind: k6.overlap_plain(kind, q, k).cpu().numpy() for kind in k6.KINDS}
    assert k6.launches == dict.fromkeys(k6.KINDS, 1)
    np.testing.assert_allclose(out["mxu"], ref["mxu"], rtol=0, atol=MXU_TOL)
    np.testing.assert_array_equal(out["vpu"], 10.0 * k6.FK)
    np.testing.assert_array_equal(np.round(out["mixed"] - out["mxu"]),
                                  np.round(ref["mixed"] - ref["mxu"]))
