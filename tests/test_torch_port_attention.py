"""The port's top-k attention (kernels K1 and K2, and K3: their 'high' and
'bfloat16' compute modes) against the JAX package's Pallas kernel, which runs
here in interpret mode in the same mode.

The plain PyTorch version is what a CPU tensor runs; the CUDA kernel is held
against it on the card (marked `cuda`, skipped without one).

Tolerances.  'float32' and 'high': 1e-4, as tests/test_pallas_attention.py:
outputs are convex mixes of the values and the affinity sums run in another
order ('high' keeps about 16 bits of each operand and drops only the lo.lo
term on both sides).  'bfloat16': max |diff| <= 2^-7 max|v| and mean |diff| <=
1e-4 max|v|.  There the weight w of a selected key is computed in float32 and
rounded to bfloat16 before it multiplies its value; the two sides sum the
affinities (and the bank's norms, before its rounding to bfloat16) in another
order, so a w can land one float32 ulp apart and round to the neighbouring
bfloat16 value, which moves an output by up to 2^-8 w |v| / z <= 2^-8 max|v|
(w <= 1 <= z).  Such flips are rare, hence the mean.

On the card the kernel sums the affinities on the tensor cores, in an order
the plain version cannot repeat, so each query pixel is held to its mode's
limit (1e-4 in 'float32' and 'high', 2^-7 max|v| in 'bfloat16') except
near-tie rows (``near_tie_rows``: the plain k-th and (k+1)-th largest live
affinities within 1e-4), where rounding can change a member: rows beyond the
limit must all be near-tie rows, at most 0.1% of the rows (at least one).
Ties within the kernel stay exact: row blocks equal the unsharded kernel bit
for bit.
"""

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.ops.cuda import topk_attention as k1

TOL = 1e-4
MODES = ("float32", "high", "bfloat16")


def _mode_params(names, modes=MODES):
    """(name, mode) cases; the float32 cases keep their bare names as ids."""
    return [pytest.param(n, m, id=n if m == "float32" else f"{n}-{m}")
            for m in modes for n in sorted(names)]


NEAR_TIE_SHARE = 1e-3


def _assert_kernel_close(out, ref, value, mode, near_fn):
    """The kernel against the plain version on the card, row by row (the
    module docstring): near_fn() gives the plain near-tie rows."""
    limit = 2.0 ** -7 * float(value.abs().max()) if mode == "bfloat16" else TOL
    beyond = (out - ref).abs().amax(-1) > limit
    if beyond.any():
        assert not (beyond & ~near_fn()).any()
        assert beyond.sum().item() <= max(1.0, NEAR_TIE_SHARE * beyond.numel())


def _assert_close(out, ref, value, mode):
    if mode != "bfloat16":
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
        return
    vmax = float(np.abs(value).max())
    diff = np.abs(out - ref)
    assert diff.max() <= 2.0 ** -7 * vmax, diff.max()
    assert diff.mean() <= 1e-4 * vmax, diff.mean()


def _pallas(bank, value, frame_idx, key_valid, *, H, W, radius, topk, tile,
            temperature=0.07, mask_shape="circle", compute_dtype="float32"):
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import (
        fused_topk_attention_banked,
        pad_key_bank_pallas,
    )

    kpad = pad_key_bank_pallas(jnp.asarray(bank), radius, tile=tile,
                               compute_dtype=compute_dtype)
    halo, Hp, Wp = int(radius), -(-H // tile) * tile, -(-W // tile) * tile
    return np.asarray(
        fused_topk_attention_banked(
            kpad[int(frame_idx[-1]) + 1, halo:halo + Hp, halo:halo + Wp],
            kpad, jnp.asarray(value),
            frame_idx=jnp.asarray(frame_idx, jnp.int32),
            key_valid=jnp.asarray(key_valid), H=H, W=W, radius=radius,
            temperature=temperature, topk=topk, tile=tile, mask_shape=mask_shape,
            compute_dtype=compute_dtype, interpret=True,
        )
    )


def _port(bank, value, frame_idx, key_valid, *, H, W, radius, topk, tile,
          temperature=0.07, device="cpu", mask_shape="circle", compute_dtype="float32"):
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, W, radius, tile)
    kpad = k1.pad_key_bank(torch.from_numpy(bank).to(device), radius, tile=tile,
                           compute_dtype=compute_dtype)
    qpad = kpad[int(frame_idx[-1]) + 1, halo:halo + Hp, halo:halo + Wp].contiguous()
    return k1.topk_attention_banked(
        qpad, kpad, torch.from_numpy(value).to(device), frame_idx=frame_idx,
        key_valid=key_valid, H=H, W=W, radius=radius, temperature=temperature,
        topk=topk, tile=tile, mask_shape=mask_shape, compute_dtype=compute_dtype,
    )


CASES = {
    # name: (H, W, tile, radius, topk, frame_idx, key_valid, dup_frame0)
    "square_16": (16, 16, 8, 4.0, 4, [0, 1, 2], [True, True, True], False),
    "rect_24x16_invalid_slot": (24, 16, 8, 4.0, 4, [0, 1, 2], [True, False, True], False),
    "radius3": (16, 16, 8, 3.0, 5, [0, 2, 1], [True, True, True], False),
    "underfull_topk": (16, 16, 8, 1.5, 10, [0, 1], [True, True], False),
    # the first propagation step: frame 0 in two valid slots, same values
    "duplicated_frame0": (16, 16, 8, 4.0, 4, [0, 0, 0, 0], [True, False, False, True], True),
    "all_slots_invalid": (16, 16, 8, 4.0, 4, [0, 1], [False, False], False),
}


@pytest.mark.parametrize("name,mode", _mode_params(CASES))
def test_plain_matches_pallas(name, mode):
    bank, value, fidx, valid, kw = _case_inputs(name, CASES, C=8, Cv=5)
    ref = _pallas(bank, value, fidx, valid, compute_dtype=mode, **kw)
    out = _port(bank, value, fidx, valid, compute_dtype=mode, **kw).numpy()
    assert out.shape == (kw["H"], kw["W"], 5)
    _assert_close(out, ref, value, mode)


def _case_inputs(name, cases, C, Cv):
    H, W, tile, radius, topk, fidx, valid, dup = cases[name]
    rng = np.random.default_rng(sorted(cases).index(name))
    bank = rng.standard_normal((max(fidx) + 2, H, W, C)).astype(np.float32)
    value = rng.random((len(fidx), H, W, Cv)).astype(np.float32)
    if dup:
        value[-1] = value[0]
    return bank, value, fidx, valid, dict(H=H, W=W, radius=radius, topk=topk, tile=tile)


@pytest.mark.parametrize("name,mode", _mode_params(CASES))
def test_plain_matches_pallas_square(name, mode):
    """K1 with the square window of the VOS paths (|dy|, |dx| <= radius)."""
    bank, value, fidx, valid, kw = _case_inputs(name, CASES, C=8, Cv=5)
    ref = _pallas(bank, value, fidx, valid, mask_shape="square", compute_dtype=mode, **kw)
    out = _port(bank, value, fidx, valid, mask_shape="square", compute_dtype=mode,
                **kw).numpy()
    _assert_close(out, ref, value, mode)
    circle = _port(bank, value, fidx, valid, compute_dtype=mode, **kw).numpy()
    # at radius 1.5 both windows are the 3 x 3 square; with every slot
    # invalid both outputs are 0
    if name not in ("all_slots_invalid", "underfull_topk"):
        assert np.abs(out - circle).max() > 1e-3  # the window really changed


def test_plain_chunks_give_the_same_result(monkeypatch):
    """The plain version runs rows of query tiles at a time; one tile per
    chunk gives the whole grid's result bit for bit."""
    cases = {"ragged": (40, 48, 16, 6.0, 10, [0, 1, 2], [True, True, True], False)}
    bank, value, fidx, valid, kw = _case_inputs("ragged", cases, C=8, Cv=5)
    halo, Hp, Wp, _, _ = k1.bank_geometry(kw["H"], kw["W"], kw["radius"], kw["tile"])
    kpad = k1.pad_key_bank(torch.from_numpy(bank), kw["radius"], tile=kw["tile"])
    qpad = kpad[3, halo:halo + Hp, halo:halo + Wp].contiguous()
    args = (qpad, kpad, torch.from_numpy(value))
    full = k1.topk_attention_banked_plain(*args, frame_idx=fidx, key_valid=valid, **kw)
    monkeypatch.setattr(k1, "PLAIN_CHUNK_TILES", 1)
    one = k1.topk_attention_banked_plain(*args, frame_idx=fidx, key_valid=valid, **kw)
    np.testing.assert_array_equal(one.numpy(), full.numpy())


UNBANKED = {
    # name: (normalize, mask_shape)
    "norm_circle": (True, "circle"),
    "norm_square": (True, "square"),
    "raw_circle": (False, "circle"),
    "raw_square": (False, "square"),
}


def _unbanked_inputs(seed, H=20, W=12, C=8, Cv=5, Tb=5, T=4):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((H, W, C)).astype(np.float32)
    key = rng.standard_normal((Tb, H, W, C)).astype(np.float32)
    key[1] = query + 0.1 * key[1]  # a near match, so the window matters
    value = rng.random((T, H, W, Cv)).astype(np.float32)
    return query, key, value, [True, False, True, True]


@pytest.mark.parametrize("name,mode", _mode_params(UNBANKED))
def test_unbanked_plain_matches_pallas(name, mode):
    """K2: the unbanked entry, normalising and padding per call, against
    fused_topk_attention in interpret mode (keys Tb > T, one invalid slot)."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import fused_topk_attention

    normalize, mask_shape = UNBANKED[name]
    query, key, value, valid = _unbanked_inputs(sorted(UNBANKED).index(name))
    kw = dict(radius=3.0, temperature=0.07, topk=4, normalize=normalize, tile=8,
              mask_shape=mask_shape, compute_dtype=mode)
    ref = np.asarray(fused_topk_attention(
        jnp.asarray(query), jnp.asarray(key), jnp.asarray(value),
        key_valid=jnp.asarray(valid), interpret=True, **kw))
    args = (torch.from_numpy(query), torch.from_numpy(key), torch.from_numpy(value))
    out = k1.topk_attention(*args, key_valid=valid, **kw).numpy()
    assert out.shape == value.shape[1:]
    _assert_close(out, ref, value, mode)
    np.testing.assert_array_equal(
        out, k1.topk_attention_plain(*args, key_valid=valid, **kw).numpy())


@pytest.mark.parametrize("H,W,tile,radius", [(24, 16, 8, 4.0), (20, 12, 8, 3.0), (16, 16, 16, 15.0)])
def test_padded_bank_matches_pallas(H, W, tile, radius):
    """The geometry and the padding are exact; the normalised values agree
    to float32 rounding (the norm's sum runs in another order)."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import pad_key_bank_pallas

    rng = np.random.default_rng(5)
    bank = rng.standard_normal((3, H, W, 8)).astype(np.float32)
    for normalize in (False, True):
        ref = np.asarray(pad_key_bank_pallas(jnp.asarray(bank), radius, tile=tile,
                                             normalize=normalize))
        out = k1.pad_key_bank(torch.from_numpy(bank), radius, tile=tile,
                              normalize=normalize).numpy()
        assert out.shape == ref.shape
        np.testing.assert_array_equal(out == 0, ref == 0)
        if normalize:
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(out, ref)


def _tie_case(C):
    """Three identical-feature keys tie for top-1 with distinct one-hot
    values: the threshold weight splits 1/3 each at pixel (0, 0)."""
    H = W = 8
    rng = np.random.default_rng(3)
    a = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    bank = np.broadcast_to(b, (2, H, W, C)).copy()
    for (y, x) in [(0, 0), (0, 1), (1, 1)]:
        bank[0, y, x] = a
    bank[1] = a  # the query frame: every pixel matches `a` best
    v = np.eye(H * W, dtype=np.float32).reshape(1, H, W, H * W)
    expect = np.zeros(H * W, np.float32)
    expect[[0, 1, 9]] = 1.0 / 3.0
    return bank, v, dict(H=H, W=W, radius=2.0, topk=1, tile=8), expect


# 'bfloat16' rounds the tied weight 1/3 to bf16: 0.333984375, 2^-9.6 off
TIE_TOL = {"float32": 1e-5, "high": 1e-5, "bfloat16": 2.0 ** -9}


def test_tie_semantics_at_threshold():
    """The Pallas kernel's rule
    (tests/test_pallas_attention.py::test_tie_semantics_at_threshold)."""
    test_tie_semantics_at_threshold_in_mode("float32")


@pytest.mark.parametrize("mode", ["high", "bfloat16"])
def test_tie_semantics_at_threshold_in_mode(mode):
    """The same rule in the K3 modes: bf16 operands keep the three keys
    tied."""
    bank, v, kw, expect = _tie_case(C=4)
    ref = _pallas(bank, v, [0], [True], compute_dtype=mode, **kw)[0, 0]
    out = _port(bank, v, [0], [True], compute_dtype=mode, **kw).numpy()[0, 0]
    np.testing.assert_allclose(ref, expect, atol=TIE_TOL[mode])
    np.testing.assert_allclose(out, expect, atol=TIE_TOL[mode])
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_tie_semantics_on_card(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    bank, v, kw, expect = _tie_case(C=16)
    out = _port(bank, v, [0], [True], device="cuda", compute_dtype=mode,
                **kw).cpu().numpy()[0, 0]
    np.testing.assert_allclose(out, expect, atol=TIE_TOL[mode])


def test_near_tie_rows_classifies_rows():
    """The classifier chip_smoke.py holds the kernel to: a row is a near tie
    where its k-th and (k+1)-th largest live affinities lie within the
    tolerance, a k-th value held by more keys than the selection takes
    included; rows with at most k live keys never are."""
    neg = k1.NEG
    k = 10
    rows = torch.full((7, 40), neg)
    ramp = torch.arange(30, 0, -1, dtype=torch.float32) * 0.5
    rows[:, :30] = ramp
    rows[1, 10] = rows[1, 9] - 5e-5            # (k+1)-th just below the k-th
    rows[2, 10] = rows[2, 9] - 5e-4            # ... but beyond the tolerance
    rows[3, 8:11] = rows[3, 8]                 # k-th value held thrice, two taken
    rows[4, 10:] = neg                         # exactly k live keys
    rows[5, 0] = rows[5, 1]                    # a tie above the k-th: no effect
    rows[6] = rows[0][torch.randperm(40, generator=torch.Generator().manual_seed(0))]
    near = k1.near_tie_rows(rows, k)
    assert near.tolist() == [False, True, False, True, False, False, False]
    assert k1.near_tie_rows(rows, k, tol=1e-3)[2]
    assert k1.near_tie_rows(rows[:, :k], k).tolist() == [False] * 7  # no (k+1)-th
    # for pass B's counts a tie just above the k-th counts too
    rows[0, 8] = rows[0, 9] + 5e-5
    assert k1.near_tie_rows(rows, k, stats=True).tolist() == [True, True, False, True, False,
                                                                False, False]
    assert not k1.near_tie_rows(rows, k)[0]


def test_near_tie_rows_plain_marks_the_tied_pixel():
    """Three keys tie for top-1 at pixel (0, 0) of the tie case (one query
    pixel of the plain version, by the banked entry's arguments); random
    distinct features have few near ties."""
    bank, v, kw, _ = _tie_case(C=4)
    halo, Hp, Wp, _, _ = k1.bank_geometry(kw["H"], kw["W"], kw["radius"], kw["tile"])
    kpad = k1.pad_key_bank(torch.from_numpy(bank), kw["radius"], tile=kw["tile"])
    args = dict(qpad=kpad[1, halo:halo + Hp, halo:halo + Wp].contiguous(), kpad=kpad,
                value=torch.from_numpy(v), frame_idx=[0], key_valid=[True], temperature=0.07,
                **kw)
    near = k1.near_tie_rows_plain(**args)
    assert near.shape == (kw["H"], kw["W"]) and near.dtype == torch.bool
    assert near[0, 0]
    bank, value, fidx, valid, kw = _case_inputs("square_16", CASES, C=8, Cv=5)
    kpad = k1.pad_key_bank(torch.from_numpy(bank), kw["radius"], tile=kw["tile"])
    halo, Hp, Wp, _, _ = k1.bank_geometry(kw["H"], kw["W"], kw["radius"], kw["tile"])
    near = k1.near_tie_rows_plain(
        kpad[fidx[-1] + 1, halo:halo + Hp, halo:halo + Wp].contiguous(), kpad,
        torch.from_numpy(value), frame_idx=fidx, key_valid=valid, temperature=0.07, **kw)
    assert near.float().mean() < 0.05


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.standard_normal((2, 16, 16, 8)).astype(np.float32))
    kpad = k1.pad_key_bank(bank, 4.0, tile=8)
    v = torch.zeros((2, 16, 16, 3))
    halo, Hp, Wp, _, _ = k1.bank_geometry(16, 16, 4.0, 8)
    q = kpad[0, halo:halo + Hp, halo:halo + Wp].contiguous()
    kw = dict(H=16, W=16, radius=4.0, topk=4, tile=8)
    with pytest.raises(ValueError):
        k1.topk_attention_banked(q[:8], kpad, v, frame_idx=[0, 1], key_valid=[True, True], **kw)
    with pytest.raises(ValueError):
        k1.topk_attention_banked(q, kpad, v, frame_idx=[0, 2], key_valid=[True, True], **kw)
    with pytest.raises(ValueError):
        k1.topk_attention_banked(q, kpad, v, frame_idx=[0], key_valid=[True], **kw)
    with pytest.raises(ValueError):
        k1.topk_attention_banked(q, kpad, v, frame_idx=[0, 1], key_valid=[True, True],
                                 mask_shape="diamond", **kw)
    with pytest.raises(ValueError):
        k1.topk_attention(bank[0], bank[:, :8], v, radius=4.0, tile=8)


CARD_CASES = {
    **CASES,
    # ragged query grid, value width below a warp, the t = 1 tie at top-10
    "ragged_40x48_tie": (40, 48, 16, 6.0, 10, [0, 0, 0], [True, False, True], True),
    "ragged_40x48_distinct": (40, 48, 16, 6.0, 10, [0, 1, 2], [True, True, True], False),
}


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


def _banked_on_card(name, mode, Cv, mask_shape):
    """One launch of the banked entry in `mode` on the card, against the
    plain version on the same card tensors (C = 16: the kernel stages
    channels 16 at a time); the launch counts move for that entry and mode
    only."""
    _card_or_skip()
    bank, value, fidx, valid, kw = _case_inputs(name, CARD_CASES, C=16, Cv=Cv)
    halo, Hp, Wp, _, _ = k1.bank_geometry(kw["H"], kw["W"], kw["radius"], kw["tile"])
    kpad = k1.pad_key_bank(torch.from_numpy(bank).cuda(), kw["radius"], tile=kw["tile"],
                           compute_dtype=mode)
    before = (k1.launches, k1.unbanked_launches, dict(k1.mode_launches))
    out = _port(bank, value, fidx, valid, device="cuda", mask_shape=mask_shape,
                compute_dtype=mode, **kw)
    torch.cuda.synchronize()
    modes = {m: n + (m == mode) for m, n in before[2].items()}
    assert (k1.launches, k1.unbanked_launches, k1.mode_launches) == (
        before[0] + 1, before[1], modes)
    args = dict(qpad=kpad[fidx[-1] + 1, halo:halo + Hp, halo:halo + Wp].contiguous(), kpad=kpad,
                value=torch.from_numpy(value).cuda(), frame_idx=fidx, key_valid=valid,
                temperature=0.07, mask_shape=mask_shape, compute_dtype=mode, **kw)
    ref = k1.topk_attention_banked_plain(**args)
    _assert_kernel_close(out, ref, args["value"], mode, lambda: k1.near_tie_rows_plain(**args))


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", _mode_params(CARD_CASES))
def test_kernel_matches_plain_on_card(name, mode):
    """K1 (K3 in 'high' and 'bfloat16'), circle window, 7 value channels."""
    _banked_on_card(name, mode, Cv=7, mask_shape="circle")


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", _mode_params(CARD_CASES))
def test_kernel_matches_plain_on_card_square(name, mode):
    """K1 with the square window against the plain version on the card;
    5 value channels, as DAVIS VOS with 4 objects gives."""
    _banked_on_card(name, mode, Cv=5, mask_shape="square")


# the zoo's K1 launches at their eval sizes: (H, W, C, Cv, window); DINO
# S/8 and B/8 on TAP-Vid (32 x 32 at C = 384 and 768), HRNet-W18 on TAP-Vid
# (8 x 8 at C = 144: one partial tile, the window wider than the map, and
# half of the last bfloat16 channel stage zeros), DINO B/8 on DAVIS VOS
ZOO_CARD_SHAPES = {
    "dino_s8_32x32x384": (32, 32, 384, 32, "circle"),
    "dino_b8_32x32x768": (32, 32, 768, 32, "circle"),
    "hrnet_8x8x144": (8, 8, 144, 32, "circle"),
    "dino_b8_vos_60x110x768": (60, 110, 768, 5, "square"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", _mode_params(ZOO_CARD_SHAPES))
def test_kernel_matches_plain_on_card_zoo_shapes(name, mode):
    """K1 (K3 in 'high' and 'bfloat16') at the zoo's widths and grids, with
    the eval settings (6 slots, radius 15, top-10, tile 16), against the
    plain version on the card."""
    _card_or_skip()
    H, W, C, Cv, mask_shape = ZOO_CARD_SHAPES[name]
    rng = np.random.default_rng(sorted(ZOO_CARD_SHAPES).index(name))
    bank = torch.from_numpy(rng.standard_normal((7, H, W, C), dtype=np.float32)).cuda()
    kpad = k1.pad_key_bank(bank, 15.0, tile=16, compute_dtype=mode)
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, W, 15.0, 16)
    args = dict(qpad=kpad[6, halo:halo + Hp, halo:halo + Wp].contiguous(), kpad=kpad,
                value=torch.from_numpy(rng.random((6, H, W, Cv), dtype=np.float32)).cuda(),
                frame_idx=list(range(6)), key_valid=[True] * 6, H=H, W=W, radius=15.0,
                temperature=0.07, topk=10, tile=16, mask_shape=mask_shape,
                compute_dtype=mode)
    out = k1.topk_attention_banked(**args)
    ref = k1.topk_attention_banked_plain(**args)
    torch.cuda.synchronize()
    _assert_kernel_close(out, ref, args["value"], mode, lambda: k1.near_tie_rows_plain(**args))


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", _mode_params(UNBANKED))
def test_unbanked_kernel_matches_plain_on_card(name, mode):
    """K2 (K3's unbanked entry in 'high' and 'bfloat16') against its plain
    version on the card (C = 16, Cv = 5)."""
    _card_or_skip()
    normalize, mask_shape = UNBANKED[name]
    query, key, value, valid = _unbanked_inputs(
        sorted(UNBANKED).index(name), H=40, W=48, C=16)
    kw = dict(radius=6.0, temperature=0.07, topk=10, normalize=normalize, tile=16,
              mask_shape=mask_shape, key_valid=valid, compute_dtype=mode)
    args = [torch.from_numpy(x).cuda() for x in (query, key, value)]
    before = (k1.launches, k1.unbanked_launches, k1.mode_launches[mode])
    out = k1.topk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (k1.launches, k1.unbanked_launches, k1.mode_launches[mode]) == (
        before[0], before[1] + 1, before[2] + 1)
    ref = k1.topk_attention_plain(*args, **kw)
    _assert_kernel_close(out, ref, args[2], mode,
                         lambda: k1.near_tie_rows_plain_unbanked(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("mask_shape", ["circle", "square"])
@pytest.mark.parametrize("name,mode", _mode_params(
    ["ragged_40x48_tie", "ragged_40x48_distinct"]))
def test_row_block_kernel_matches_plain_on_card(name, mode, mask_shape, S):
    """K4: each row block (40 rows over S blocks of a grid over-padded to S
    blocks of 16 or 32 rows) against its plain version on the card; the
    blocks, gathered and cut to H, equal the unsharded kernel bit for bit.
    Only the row-block count and the mode's count move."""
    _card_or_skip()
    bank, value, fidx, valid, kw = _case_inputs(name, CARD_CASES, C=16, Cv=5)
    H, tile = kw["H"], kw["tile"]
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, kw["W"], kw["radius"], tile)
    hb = -(-(-(-Hp // S)) // tile) * tile
    grid = S * hb
    feats = torch.from_numpy(bank).cuda()
    v = torch.from_numpy(value).cuda()
    args = dict(frame_idx=fidx, key_valid=valid, temperature=0.07, mask_shape=mask_shape,
                compute_dtype=mode, **kw)
    kpad = k1.pad_key_bank(feats, kw["radius"], tile=tile, compute_dtype=mode)
    q = fidx[-1] + 1
    full = k1.topk_attention_banked(kpad[q, halo:halo + Hp, halo:halo + Wp].contiguous(),
                                    kpad, v, **args)
    tall = k1.pad_key_bank(feats, kw["radius"], tile=tile, compute_dtype=mode, grid_rows=grid)
    before = (k1.launches, k1.unbanked_launches, k1.row_block_launches, k1.mode_launches[mode])
    blocks = []
    for r0 in range(0, grid, hb):
        qblk = tall[q, halo + r0:halo + r0 + hb, halo:halo + Wp].contiguous()
        blk = dict(qpad=qblk, kpad=tall, value=v, row0=r0, grid_rows=grid, **args)
        out = k1.topk_attention_banked(**blk)
        ref = k1.topk_attention_banked_plain(**blk)
        assert out.shape == (hb, kw["W"], 5)
        _assert_kernel_close(out, ref, v, mode, lambda: k1.near_tie_rows_plain(**blk))
        assert not out[max(H - r0, 0):].any()  # block rows at or past H
        blocks.append(out)
    torch.cuda.synchronize()
    assert (k1.launches, k1.unbanked_launches, k1.row_block_launches,
            k1.mode_launches[mode]) == (before[0], before[1], before[2] + S, before[3] + S)
    assert torch.equal(torch.cat(blocks)[:H], full)


# --------------------------------------------------------------------- #
# K3 set-up: operand dtypes per mode
# --------------------------------------------------------------------- #
def test_pallas_compute_dtype_mapping():
    from fgvc_tpu.ops.pallas.topk_attention import _PALLAS_PRECISIONS, pallas_compute_dtype

    for precision in ("highest", "high", "default", "fast"):
        assert k1.pallas_compute_dtype(precision) == pallas_compute_dtype(precision)
    assert {m: str(d).split(".")[-1] for m, d in k1.COMPUTE_DTYPES.items()} == {
        m: np.dtype(d).name for m, d in _PALLAS_PRECISIONS.items()}


@pytest.mark.parametrize("mode", MODES)
def test_bank_dtype_per_mode(mode):
    """pad_key_bank normalises in float32 and stores the mode's dtype, as
    pad_key_bank_pallas: bf16 banks agree to one bf16 ulp (2^-7 relative; a
    norm summed in another order can put a value on the other side of a
    rounding midpoint), f32 banks to float32 rounding."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import pad_key_bank_pallas

    bank = np.random.default_rng(6).standard_normal((3, 20, 12, 8)).astype(np.float32)
    ref = pad_key_bank_pallas(jnp.asarray(bank), 3.0, tile=8, compute_dtype=mode)
    out = k1.pad_key_bank(torch.from_numpy(bank), 3.0, tile=8, compute_dtype=mode)
    assert out.dtype == k1.COMPUTE_DTYPES[mode]
    assert str(out.dtype).split(".")[-1] == np.dtype(ref.dtype).name
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.to(torch.float32).numpy()
    np.testing.assert_array_equal(out == 0, ref == 0)
    rel = 2.0 ** -7 if mode == "bfloat16" else 1e-6
    np.testing.assert_allclose(out, ref, rtol=rel, atol=1e-7)
    if mode == "bfloat16":
        assert (out == ref).mean() > 0.99  # only near-midpoint values round apart


def test_mode_operand_checks():
    """'high' on a bf16 bank raises ValueError (the Pallas kernel's rule: its
    lo halves would be zero); other dtypes off the mode's raise TypeError, on
    the CPU as on the card."""
    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.standard_normal((2, 16, 16, 8)).astype(np.float32))
    v = torch.zeros((2, 16, 16, 3))
    halo, Hp, Wp, _, _ = k1.bank_geometry(16, 16, 4.0, 8)
    kw = dict(frame_idx=[0, 1], key_valid=[True, True], H=16, W=16, radius=4.0,
              topk=4, tile=8)
    kb = k1.pad_key_bank(bank, 4.0, tile=8, compute_dtype="bfloat16")
    kf = k1.pad_key_bank(bank, 4.0, tile=8)
    qb = kb[0, halo:halo + Hp, halo:halo + Wp].contiguous()
    qf = kf[0, halo:halo + Hp, halo:halo + Wp].contiguous()
    with pytest.raises(ValueError, match="float32 query/key"):
        k1.topk_attention_banked(qb, kb, v, compute_dtype="high", **kw)
    with pytest.raises(TypeError):
        k1.topk_attention_banked(qf, kf, v, compute_dtype="bfloat16", **kw)
    with pytest.raises(TypeError):
        k1.topk_attention_banked(qb, kb, v, **kw)
    with pytest.raises(TypeError):
        k1.topk_attention_banked(qb, kb, v.double(), compute_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        k1.topk_attention_banked(qf, kf, v, compute_dtype="tf32", **kw)
    out = k1.topk_attention_banked(qb, kb, v, compute_dtype="bfloat16", **kw)
    assert out.dtype == torch.float32


@pytest.mark.cuda
def test_kernel_mode_checks_on_card():
    """The card's wrapper raises where the CPU's does, before any launch."""
    _card_or_skip()
    bank = torch.randn((2, 16, 16, 16), device="cuda")
    kb = k1.pad_key_bank(bank, 4.0, tile=8, compute_dtype="bfloat16")
    halo, Hp, Wp, _, _ = k1.bank_geometry(16, 16, 4.0, 8)
    qb = kb[0, halo:halo + Hp, halo:halo + Wp].contiguous()
    v = torch.zeros((2, 16, 16, 3), device="cuda")
    before = k1.launches
    with pytest.raises(ValueError, match="float32 query/key"):
        k1.topk_attention_banked(qb, kb, v, frame_idx=[0, 1], key_valid=[True, True],
                                 H=16, W=16, radius=4.0, topk=4, tile=8,
                                 compute_dtype="high")
    assert k1.launches == before


# --------------------------------------------------------------------- #
# select_kernel (passes B and C) on rows with exact affinities
# --------------------------------------------------------------------- #
# Integer features on a few channels, no normalisation, temperature 1
# (bench/compare_source.py's integer_tie_inputs): every mode computes these
# affinities exactly, on the card as in the plain version and in JAX, so the
# statistics of pass B are held exactly and only the summation orders of z
# and of the value mix differ: the float32 bound of a sum of that many terms,
# at least 1e-6 relative (tie_heavy_limits; rows of the flat quarter sum
# thousands of tied keys).


def _tie_heavy(H, W, T=6, Cv=7, seed=0):
    from fgvc_tpu_torch.bench.compare_source import integer_tie_inputs

    return integer_tie_inputs(H, W, slots=T, cv=Cv, seed=seed)


def _tie_kw(mode, passes, radius=6.0, topk=10, tile=16, mask_shape="circle", key_valid=None):
    return dict(radius=radius, temperature=1.0, topk=topk, normalize=False, tile=tile,
                mask_shape=mask_shape, key_valid=key_valid, compute_dtype=mode,
                debug_passes=passes)


def _assert_stats_exact(out, ref, mode, topk):
    """[thresh, mmax, z, frac, n_above, cnt_at]: all but z equal, z within
    its summation bound."""
    from fgvc_tpu_torch.bench.compare_source import tie_heavy_limits

    assert out.shape == ref.shape
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(out[..., i].numpy(), ref[..., i].numpy())
    z_rtol, _ = tie_heavy_limits(ref, mode, topk)
    np.testing.assert_allclose(out[..., 2].numpy(), ref[..., 2].numpy(), rtol=z_rtol, atol=0)


def _assert_mix_close(out, ref, stats, value, mode, topk):
    """Each row of the output within its summation bound of max |v|."""
    from fgvc_tpu_torch.bench.compare_source import tie_heavy_limits

    _, limit = tie_heavy_limits(stats, mode, topk)
    assert ((out - ref).abs().amax(-1) <= limit * value.abs().max()).all()


@pytest.mark.parametrize("mode", MODES)
def test_plain_stats_match_pallas_on_tie_heavy_rows(mode):
    """The plain version, the oracle the card is held to, against JAX's
    Pallas-interpreted fused_topk_attention on the tie-heavy integer rows:
    cut 'ab''s threshold and counts equal, and the whole kernel."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import fused_topk_attention

    q, k, v = _tie_heavy(16, 16, T=3)
    for passes in ("ab", "abc"):
        kw = _tie_kw(mode, passes, radius=4.0, tile=8)
        ref = np.asarray(fused_topk_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
            **{n: x for n, x in kw.items() if n != "key_valid"}))
        out = k1.topk_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                **kw).numpy()
        if passes == "ab":
            _assert_stats_exact(torch.tensor(out), torch.tensor(ref), mode, kw["topk"])
            assert (out[..., 5] > 1).mean() > 0.25  # most rows tie at their threshold
        else:
            _assert_close(out, ref, v, mode)


def _tie_on_card(q, k, v, **kw):
    """Kernel and plain version of the unbanked entry on the card; cut 'ab'
    and the whole kernel against the plain version; returns the kernel's
    (stats, output)."""
    _card_or_skip()
    args = [torch.from_numpy(x).cuda() for x in (q, k, v)]
    mode, topk = kw["compute_dtype"], kw["topk"]
    res = []
    for passes in ("ab", "abc"):
        out = k1.topk_attention(*args, **{**kw, "debug_passes": passes}).cpu()
        ref = k1.topk_attention_plain(*args, **{**kw, "debug_passes": passes}).cpu()
        if passes == "ab":
            _assert_stats_exact(out, ref, mode, topk)
            stats = ref
        else:
            _assert_mix_close(out, ref, stats, torch.from_numpy(v), mode, topk)
        res.append(out)
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("topk,mask_shape", [(1, "circle"), (10, "square"), (31, "circle")])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_tie_heavy_exact_on_card(mode, topk, mask_shape):
    """select_kernel on tie-heavy rows (the flat quarter ties thousands of
    keys, beyond the candidate buffer), at k = 1, 10 and 31: the
    statistics exact, z and the output to summation order."""
    q, k, v = _tie_heavy(40, 48)
    stats, _ = _tie_on_card(q, k, v, **_tie_kw(mode, "abc", topk=topk, mask_shape=mask_shape))
    assert (stats[..., 5] > 1).float().mean() > 0.25
    assert stats[..., 5].max() > 512  # rows past the candidate buffer


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [6.0, 22.0])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_long_rows_on_card(mode, radius):
    """T = 16 slots: rows of 16 x 28^2 affinities held in shared memory, and
    of 16 x 60^2 = 57,600, longer than the on-chip path takes, swept from the
    scratch instead."""
    q, k, v = _tie_heavy(16, 16, T=16)
    _tie_on_card(q, k, v, **_tie_kw(mode, "abc", radius=radius))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_underfull_and_masked_rows_on_card(mode):
    """Rows with fewer than k live keys take every live key once; a row with
    no live key (every slot invalid) gives 0, and cut 'ab' gives thresh and
    mmax NEG (its largest element: an in-window key's NEG slot bias), no
    counts and z 1e-30."""
    q, k, v = _tie_heavy(16, 16, T=2)
    stats, _ = _tie_on_card(q, k, v, **_tie_kw(mode, "abc", radius=1.5, topk=31))
    assert (stats[..., 4] + stats[..., 5] < 31).all()  # every row under-full
    stats, out = _tie_on_card(q, k, v, **_tie_kw(mode, "abc", key_valid=[False, False]))
    assert not out.any() and (stats[..., :2] == k1.NEG).all() and not stats[..., 3:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_nan_affinities_on_card(mode):
    """NaN affinities are dead.  A NaN key (features in [1, 2], so every
    other key scores above a zero key) acts as a key that is never
    selected: the result equals the plain version with that key zeroed.  A
    NaN query pixel's row is all NaN: its output is 0."""
    _card_or_skip()
    q, k, v = _tie_heavy(16, 16, T=3)
    q[..., :4], k[..., :4] = np.abs(q[..., :4]) + 1, np.abs(k[..., :4]) + 1
    kz = k.copy()
    kz[1, 5, 6] = 0.0
    k[1, 5, 6, 0] = np.nan
    qz = q.copy()
    q[9, 3, 0] = np.nan
    qz[9, 3] = 0.0
    args = [torch.from_numpy(x).cuda() for x in (q, k, v)]
    plain = [torch.from_numpy(x).cuda() for x in (qz, kz, v)]
    for passes in ("ab", "abc"):
        kw = _tie_kw(mode, passes)
        out = k1.topk_attention(*args, **kw).cpu()
        ref = k1.topk_attention_plain(*plain, **kw).cpu()
        if passes == "abc":
            assert not out[9, 3].any()
        else:
            assert out[9, 3, 0] == k1.NEG and out[9, 3, 5] == 0
        out[9, 3], ref[9, 3] = 0.0, 0.0
        if passes == "ab":
            _assert_stats_exact(out, ref, mode, 10)
            stats = ref
        else:
            _assert_mix_close(out, ref, stats, torch.from_numpy(v), mode, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_row_blocks_tie_heavy_on_card(mode, S):
    """K4 on tie-heavy rows: the row blocks, gathered and cut to H, equal
    the unsharded kernel bit for bit."""
    _card_or_skip()
    H, W, radius, tile = 40, 48, 6.0, 16
    q, k, v = _tie_heavy(H, W)
    feats = torch.from_numpy(np.concatenate([k, q[None]])).cuda()
    value = torch.from_numpy(v).cuda()
    T = len(k)
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, W, radius, tile)
    args = dict(value=value, frame_idx=list(range(T)), key_valid=[True] * T, H=H, W=W,
                radius=radius, temperature=1.0, topk=10, tile=tile, compute_dtype=mode)
    kpad = k1.pad_key_bank(feats, radius, tile=tile, normalize=False, compute_dtype=mode)
    full = k1.topk_attention_banked(kpad[T, halo:halo + Hp, halo:halo + Wp].contiguous(),
                                    kpad, **args)
    hb = -(-(-(-Hp // S)) // tile) * tile
    tall = k1.pad_key_bank(feats, radius, tile=tile, normalize=False, compute_dtype=mode,
                           grid_rows=S * hb)
    blocks = [k1.topk_attention_banked(tall[T, halo + r0:halo + r0 + hb, halo:halo + Wp]
                                       .contiguous(), tall, row0=r0, grid_rows=S * hb, **args)
              for r0 in range(0, S * hb, hb)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(blocks)[:H], full)
