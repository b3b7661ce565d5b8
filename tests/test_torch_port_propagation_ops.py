"""The propagation modes' ops (fgvc_tpu_torch/ops/topk.py, attention.py,
windowed_attention.py, local_corr.py, warp.py, c2f.py) on the CPU against
the JAX package's, on the same seeded numpy inputs.

Tolerances: 1e-5 absolute in 'highest' (float32 sums in other orders); 'high'
(bf16x3 affinities) within 1e-4 of JAX's 'highest'; 'default' (one bf16
product) within 1e-5 of JAX run on the bf16-rounded query and keys (XLA on
the CPU computes float32, and the product of bf16 values in float32 is the
bf16 product).  Top-k members equal lax.top_k's exactly, ties included; the
t = 1 case (frame 0 in two valid slots, integer features, so the two
slots' affinities tie exactly) picks the same members as JAX; row blocks
gathered equal the whole grid bit for bit.
"""

import numpy as np
import pytest
import torch

TOL = 1e-5
HIGH_TOL = 1e-4
H, W, C, T, CV = 12, 14, 16, 4, 5   # two row and two column tiles of 8, partial
TILE, RADIUS, TOPK, TEMP = 8, 3.0, 4, 0.5
VALID = [True, False, True, True]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(
        q=_unit(rng.standard_normal((H, W, C))),
        k=_unit(rng.standard_normal((T, H, W, C))),
        v=rng.standard_normal((T, H, W, CV)).astype(np.float32),
        bank=rng.standard_normal((7, H, W, C)).astype(np.float32),
    )


# --------------------------------------------------------------------- #
# top-k
# --------------------------------------------------------------------- #
def test_top_k_orders_ties_as_lax_top_k():
    """Rows of four levels (ties everywhere) and -inf runs: top_k's values
    and indices equal lax.top_k's and a stable sort's; topk_segmented's
    equal fgvc_tpu's topk_segmented's (its own tie order)."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.ops.topk import topk_segmented as jax_segmented
    from fgvc_tpu_torch.ops.topk import top_k, topk_segmented

    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (6, 300)).astype(np.float32)
    x[0] = -np.inf
    x[1, 40:] = -np.inf
    for k in (1, 4, 10, 37):
        vals, idx = top_k(_t(x), k)
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
        srt = torch.sort(_t(x), dim=-1, descending=True, stable=True).indices[:, :k]
        assert torch.equal(idx, srt)
    for seg in (16, 128):
        vals, idx = topk_segmented(_t(x), 10, seg=seg)
        ref_vals, ref_idx = jax_segmented(jnp.asarray(x), 10, seg=seg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


# --------------------------------------------------------------------- #
# 'tiled'
# --------------------------------------------------------------------- #
TILED_CASES = {
    # name: (keyword arguments of both, bank mode)
    "exact": (dict(normalize=False), False),
    "segmented": (dict(normalize=False, topk_impl="segmented"), False),
    "certified": (dict(normalize=False, topk_impl="certified"), False),
    "approx": (dict(normalize=False, topk_impl="approx"), False),
    "cosine": (dict(normalize=False, mode="cosine"), False),
    "all_keys_normalize": (dict(topk=None, normalize=True, mask_shape="square"), False),
    "bank": (dict(normalize=False), True),
}


def _tiled_pair(data, kw, bank_mode, precision="highest", jax_round=False):
    """(port, JAX) outputs of masked_topk_attention_tiled on `data`; in bank
    mode the query is frame 2 of pad_key_bank(bank) and the slots read
    frames [3, 0, 6, 6]."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.windowed_attention import masked_topk_attention_tiled as jax_tiled
    from fgvc_tpu.ops.windowed_attention import pad_key_bank as jax_pad
    from fgvc_tpu_torch.ops.windowed_attention import masked_topk_attention_tiled, pad_key_bank

    kw = dict(dict(radius=RADIUS, temperature=TEMP, topk=TOPK, tile=TILE), **kw)
    q, k = data["q"], data["k"]
    extra = {}
    if bank_mode:
        kb = pad_key_bank(_t(data["bank"]), RADIUS, TILE)
        np.testing.assert_allclose(kb.numpy(), np.asarray(jax_pad(jnp.asarray(data["bank"]),
                                                                  RADIUS, TILE)), atol=TOL)
        k = kb.numpy()
        q = k[2, 3:3 + H, 3:3 + W]
        extra = dict(frame_idx=[3, 0, 6, 6])
    out = masked_topk_attention_tiled(_t(q), _t(k), _t(data["v"]), key_valid=VALID,
                                      precision=precision, **kw, **extra)
    jq, jk = (_bf16(q), _bf16(k)) if jax_round else (q, k)
    ref = jax_tiled(jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(data["v"]),
                    key_valid=jnp.asarray(VALID),
                    **{n: jnp.asarray(x) for n, x in extra.items()}, **kw)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_tiled_matches_jax(data, case):
    out, ref = _tiled_pair(data, *TILED_CASES[case])
    assert out.shape == (H, W, CV) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_tiled_precision_modes(data, precision):
    """'high' against JAX's 'highest'; 'default' against JAX on the
    bf16-rounded query and keys."""
    out, ref = _tiled_pair(data, dict(normalize=False), False, precision=precision,
                           jax_round=precision == "default")
    np.testing.assert_allclose(out, ref, rtol=0, atol=HIGH_TOL if precision == "high" else TOL)


@pytest.mark.parametrize("topk_impl", ["exact", "segmented"])
def test_tiled_t1_tie_picks_jax_members(topk_impl):
    """Step t = 1: frame 0 in slot 0 and slot 3, integer features, so the
    two slots' affinities tie exactly; the slots' values differ, so taking
    another member at a tie would move the output.  'exact' takes slot 0's
    copies (index order), 'segmented' splits the tie, both as JAX does."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.windowed_attention import masked_topk_attention_tiled as jax_tiled
    from fgvc_tpu_torch.ops.windowed_attention import masked_topk_attention_tiled, pad_key_bank

    rng = np.random.default_rng(2)
    f0 = np.zeros((1, H, W, C), np.float32)
    f0[..., :3] = rng.integers(-2, 3, (1, H, W, 3))
    bank = pad_key_bank(_t(f0), RADIUS, TILE) * 0  # the geometry, unnormalised below
    bank[:, 3:3 + H, 3:3 + W] = _t(f0)
    q = rng.integers(-2, 3, (H, W, C)).astype(np.float32)
    v = rng.standard_normal((T, H, W, CV)).astype(np.float32)
    kw = dict(radius=RADIUS, temperature=TEMP, topk=TOPK, tile=TILE, normalize=False,
              topk_impl=topk_impl)
    valid = [True, False, False, True]
    out = masked_topk_attention_tiled(_t(q), bank, _t(v), key_valid=valid, frame_idx=[0] * T,
                                      **kw)
    ref = jax_tiled(jnp.asarray(q), jnp.asarray(bank.numpy()), jnp.asarray(v),
                    key_valid=jnp.asarray(valid), frame_idx=jnp.zeros(T, jnp.int32), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_tiled_row_blocks_equal_whole_grid(data):
    """S = 2 row blocks of 8 rows over a bank over-padded to 16 rows,
    gathered and cut to H, equal the whole grid's bank-mode call bit for
    bit (the same tile rows in the same batched pieces)."""
    import torch.nn.functional as F

    from fgvc_tpu_torch.ops.windowed_attention import masked_topk_attention_tiled, pad_key_bank

    bank = _t(data["bank"])
    kw = dict(radius=RADIUS, temperature=TEMP, topk=TOPK, tile=TILE, normalize=False,
              key_valid=VALID, frame_idx=[3, 0, 6, 6])
    whole_bank = pad_key_bank(bank, RADIUS, TILE)
    whole = masked_topk_attention_tiled(whole_bank[2, 3:3 + H, 3:3 + W], whole_bank,
                                        _t(data["v"]), **kw)
    grid_bank = pad_key_bank(bank, RADIUS, TILE, grid_rows=16)
    q = F.pad(grid_bank[2, 3:3 + H, 3:3 + W], (0, 0, 0, 0, 0, 16 - H))
    blocks = [masked_topk_attention_tiled(q[r0:r0 + 8], grid_bank, _t(data["v"]),
                                          row_offset=r0, full_h=H, grid_rows=16, **kw)
              for r0 in (0, 8)]
    assert torch.equal(torch.cat(blocks)[:H], whole)


def test_tiled_refuses_unknown_modes(data):
    from fgvc_tpu_torch.ops.windowed_attention import masked_topk_attention_tiled

    args = (_t(data["q"]), _t(data["k"]), _t(data["v"]))
    with pytest.raises(ValueError, match="unknown topk_impl"):
        masked_topk_attention_tiled(*args, radius=RADIUS, topk_impl="fast")
    with pytest.raises(ValueError, match="unknown mode"):
        masked_topk_attention_tiled(*args, radius=RADIUS, mode="l1")


# --------------------------------------------------------------------- #
# 'dense'
# --------------------------------------------------------------------- #
DENSE_CASES = {
    "circle": dict(non_mask_len=0),
    "first_unmasked": dict(non_mask_len=1),
    "l2_distance_square": dict(non_mask_len=0, sim_mode="l2-distance", mask_shape="square"),
}


def _dense_pair(data, kw, precision="highest", jax_round=False):
    import jax.numpy as jnp

    from fgvc_tpu.ops.attention import masked_topk_attention as jax_dense
    from fgvc_tpu_torch.ops.attention import masked_topk_attention

    kw = dict(dict(radius=RADIUS, temperature=TEMP, topk=TOPK, normalize=False, step=50), **kw)
    out = masked_topk_attention(_t(data["q"]), _t(data["k"]), _t(data["v"]), key_valid=VALID,
                                precision=precision, **kw)
    q, k = (_bf16(data["q"]), _bf16(data["k"])) if jax_round else (data["q"], data["k"])
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(data["v"]),
                    key_valid=jnp.asarray(VALID), **kw)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_matches_jax(data, case):
    out, ref = _dense_pair(data, DENSE_CASES[case])
    assert out.shape == (H, W, CV) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_dense_precision_modes(data, precision):
    out, ref = _dense_pair(data, DENSE_CASES["circle"], precision=precision,
                           jax_round=precision == "default")
    np.testing.assert_allclose(out, ref, rtol=0, atol=HIGH_TOL if precision == "high" else TOL)


def test_dense_equals_tiled_and_the_neighbor_mask():
    """On a 28 x 20 grid, where each chunk of 40 query pixels reaches 10 of
    the 28 key rows: 'dense' against JAX's with frame 0 unmasked, and
    fgvc_tpu's statement that 'tiled' is the dense attention for
    non_mask_len 0, here in the port; spatial_neighbor_mask equal to
    fgvc_tpu's."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.attention import masked_topk_attention as jax_dense
    from fgvc_tpu.ops.attention import spatial_neighbor_mask as jax_mask
    from fgvc_tpu_torch.ops.attention import masked_topk_attention, spatial_neighbor_mask
    from fgvc_tpu_torch.ops.windowed_attention import masked_topk_attention_tiled

    rng = np.random.default_rng(8)
    q, k = _unit(rng.standard_normal((28, 20, C))), _unit(rng.standard_normal((T, 28, 20, C)))
    v = rng.standard_normal((T, 28, 20, CV)).astype(np.float32)
    kw = dict(radius=RADIUS, temperature=TEMP, topk=TOPK, step=40)
    out = masked_topk_attention(_t(q), _t(k), _t(v), key_valid=VALID, non_mask_len=1, **kw)
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), non_mask_len=1,
                    key_valid=jnp.asarray(VALID), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    dense = masked_topk_attention(_t(q), _t(k), _t(v), key_valid=VALID, **kw)
    kw.pop("step")
    tiled = masked_topk_attention_tiled(_t(q), _t(k), _t(v), key_valid=VALID, tile=TILE, **kw)
    np.testing.assert_allclose(dense.numpy(), tiled.numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(spatial_neighbor_mask(5, 6, 5).numpy(),
                                  np.asarray(jax_mask(5, 6, 5)))


# --------------------------------------------------------------------- #
# c2f, flow-guided, part_unfold
# --------------------------------------------------------------------- #
def test_c2f_matches_jax():
    import jax.numpy as jnp

    from fgvc_tpu.ops.c2f import masked_attention_c2f as jax_c2f
    from fgvc_tpu_torch.ops.c2f import masked_attention_c2f

    rng = np.random.default_rng(3)
    hf = wf = 16
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((4, 4, 8), (3, 4, 4, 8), (hf, wf, 8), (3, hf, wf, 8), (3, hf, wf, CV))]
    kw = dict(radius=1.5, radius_fine=2, temperature=0.1, topk=5, step=6)
    valid = [True, False, True]
    out = masked_attention_c2f(*map(_t, arrs), key_valid=valid, **kw)
    ref = jax_c2f(*map(jnp.asarray, arrs), key_valid=jnp.asarray(valid), **kw)
    assert out.shape == (4, 4, CV)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_flow_guided_forms_match_jax():
    """Both forms against JAX, and against each other (the efficient form's
    affinities are the dense form's samples of the correlation volume)."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.c2f import flow_guided_attention as jax_dense_fg
    from fgvc_tpu.ops.c2f import flow_guided_topk_attention as jax_fg
    from fgvc_tpu_torch.ops.c2f import flow_guided_attention, flow_guided_topk_attention

    rng = np.random.default_rng(4)
    h, w, n = 10, 12, 3
    q = _unit(rng.standard_normal((h, w, 8)))
    k = _unit(rng.standard_normal((n, h, w, 8)))
    v = rng.standard_normal((n, h, w, CV)).astype(np.float32)
    fl = (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32)
    valid = [True, False, True]
    kw = dict(radius=2, temperature=0.1, topk=5)
    out = flow_guided_topk_attention(_t(q), _t(k), _t(v), _t(fl), key_valid=valid, step=50,
                                     normalize=False, **kw)
    ref = jax_fg(*map(jnp.asarray, (q, k, v, fl)), key_valid=jnp.asarray(valid), step=50,
                 normalize=False, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    corr = np.einsum("ijc,tyxc->tijyx", q, k).astype(np.float32) / 0.1
    dense = flow_guided_attention(_t(corr), _t(fl), _t(v), **kw)
    ref = jax_dense_fg(*map(jnp.asarray, (corr, fl, v)), **kw)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    every = flow_guided_topk_attention(_t(q), _t(k), _t(v), _t(fl), step=7, normalize=False, **kw)
    np.testing.assert_allclose(every.numpy(), dense.numpy(), rtol=0, atol=TOL)


def test_part_unfold_matches_jax():
    import jax.numpy as jnp

    from fgvc_tpu.ops.local_corr import part_unfold as jax_unfold
    from fgvc_tpu_torch.ops.local_corr import part_unfold

    rng = np.random.default_rng(5)
    x = rng.standard_normal((10, 12, 6)).astype(np.float32)
    coords = rng.uniform(-2, 14, (9, 2)).astype(np.float32)
    out = part_unfold(_t(x), _t(coords), 2)
    assert out.shape == (9, 5, 5, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_unfold(jnp.asarray(x),
                                                                  jnp.asarray(coords), 2)),
                               rtol=0, atol=TOL)


# --------------------------------------------------------------------- #
# warp
# --------------------------------------------------------------------- #
def test_warp_functions_match_jax():
    """forward_backward_absdiff, compute_range_map, the three
    occlusion_masks modes and compose_flows (batched here, one by one in
    JAX)."""
    import jax.numpy as jnp

    import fgvc_tpu.ops.warp as jw
    import fgvc_tpu_torch.ops.warp as pw

    rng = np.random.default_rng(6)
    f1, f2 = (rng.standard_normal((2, 10, 12, 2)) * 2).astype(np.float32)
    a, b = _t(f1)[None], _t(f2)[None]
    pairs = [
        (pw.forward_backward_absdiff(a, b)[0], jw.forward_backward_absdiff(f1, f2)),
        (pw.compute_range_map(a)[0], jw.compute_range_map(jnp.asarray(f1))),
        (pw.compose_flows(a, b)[0], jw.compose_flows(jnp.asarray(f1), jnp.asarray(f2))),
    ]
    for mode in ("consistency", "fb_abs", "range_map"):
        got = pw.occlusion_masks(a, b, mode)
        ref = jw.occlusion_masks(jnp.asarray(f1), jnp.asarray(f2), mode)
        pairs += [(got[n][0], ref[n]) for n in ("occ_fw", "occ_bw")]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="unknown occlusion mode"):
        pw.occlusion_masks(a, b, "soft")


@pytest.mark.parametrize("K", [1, 3])
def test_chain_window_flows_matches_jax(K):
    import jax.numpy as jnp

    from fgvc_tpu.ops.warp import chain_window_flows as jax_chain
    from fgvc_tpu_torch.ops.warp import chain_window_flows

    adj = np.random.default_rng(7).standard_normal((5, 10, 12, 2)).astype(np.float32)
    out = chain_window_flows(_t(adj), K)
    assert out.shape == (5, K + 1, 10, 12, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_chain(jnp.asarray(adj), K)),
                               rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="precede_frames >= 1"):
        chain_window_flows(_t(adj), 0)
