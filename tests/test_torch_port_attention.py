"""The port's top-k attention (kernels K1 and K2) against the JAX package's
Pallas kernel, which runs here in interpret mode.

The plain PyTorch version is what a CPU tensor runs; the CUDA kernel is held
against it on the card (marked `cuda`, skipped without one).  Tolerance 1e-4,
as tests/test_pallas_attention.py: outputs are convex mixes of the values and
the affinity sums run in another order.
"""

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.ops.cuda import topk_attention as k1

TOL = 1e-4


def _pallas(bank, value, frame_idx, key_valid, *, H, W, radius, topk, tile,
            temperature=0.07, mask_shape="circle"):
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import (
        fused_topk_attention_banked,
        pad_key_bank_pallas,
    )

    kpad = pad_key_bank_pallas(jnp.asarray(bank), radius, tile=tile)
    halo, Hp, Wp = int(radius), -(-H // tile) * tile, -(-W // tile) * tile
    return np.asarray(
        fused_topk_attention_banked(
            kpad[int(frame_idx[-1]) + 1, halo:halo + Hp, halo:halo + Wp],
            kpad, jnp.asarray(value),
            frame_idx=jnp.asarray(frame_idx, jnp.int32),
            key_valid=jnp.asarray(key_valid), H=H, W=W, radius=radius,
            temperature=temperature, topk=topk, tile=tile, mask_shape=mask_shape,
            interpret=True,
        )
    )


def _port(bank, value, frame_idx, key_valid, *, H, W, radius, topk, tile,
          temperature=0.07, device="cpu", mask_shape="circle"):
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, W, radius, tile)
    kpad = k1.pad_key_bank(torch.from_numpy(bank).to(device), radius, tile=tile)
    qpad = kpad[int(frame_idx[-1]) + 1, halo:halo + Hp, halo:halo + Wp].contiguous()
    return k1.topk_attention_banked(
        qpad, kpad, torch.from_numpy(value).to(device), frame_idx=frame_idx,
        key_valid=key_valid, H=H, W=W, radius=radius, temperature=temperature,
        topk=topk, tile=tile, mask_shape=mask_shape,
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas(name):
    H, W, tile, radius, topk, fidx, valid, dup = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    C, Cv, T = 8, 5, len(fidx)
    bank = rng.standard_normal((max(fidx) + 2, H, W, C)).astype(np.float32)
    value = rng.random((T, H, W, Cv)).astype(np.float32)
    if dup:
        value[-1] = value[0]
    kw = dict(H=H, W=W, radius=radius, topk=topk, tile=tile)
    ref = _pallas(bank, value, fidx, valid, **kw)
    out = _port(bank, value, fidx, valid, **kw).numpy()
    assert out.shape == (H, W, Cv)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def _case_inputs(name, cases, C, Cv):
    H, W, tile, radius, topk, fidx, valid, dup = cases[name]
    rng = np.random.default_rng(sorted(cases).index(name))
    bank = rng.standard_normal((max(fidx) + 2, H, W, C)).astype(np.float32)
    value = rng.random((len(fidx), H, W, Cv)).astype(np.float32)
    if dup:
        value[-1] = value[0]
    return bank, value, fidx, valid, dict(H=H, W=W, radius=radius, topk=topk, tile=tile)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_square(name):
    """K1 with the square window of the VOS paths (|dy|, |dx| <= radius)."""
    bank, value, fidx, valid, kw = _case_inputs(name, CASES, C=8, Cv=5)
    ref = _pallas(bank, value, fidx, valid, mask_shape="square", **kw)
    out = _port(bank, value, fidx, valid, mask_shape="square", **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    circle = _port(bank, value, fidx, valid, **kw).numpy()
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


@pytest.mark.parametrize("name", sorted(UNBANKED))
def test_unbanked_plain_matches_pallas(name):
    """K2: the unbanked entry, normalising and padding per call, against
    fused_topk_attention in interpret mode (keys Tb > T, one invalid slot)."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import fused_topk_attention

    normalize, mask_shape = UNBANKED[name]
    query, key, value, valid = _unbanked_inputs(sorted(UNBANKED).index(name))
    kw = dict(radius=3.0, temperature=0.07, topk=4, normalize=normalize, tile=8,
              mask_shape=mask_shape)
    ref = np.asarray(fused_topk_attention(
        jnp.asarray(query), jnp.asarray(key), jnp.asarray(value),
        key_valid=jnp.asarray(valid), interpret=True, **kw))
    args = (torch.from_numpy(query), torch.from_numpy(key), torch.from_numpy(value))
    out = k1.topk_attention(*args, key_valid=valid, **kw).numpy()
    assert out.shape == value.shape[1:]
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
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


def test_tie_semantics_at_threshold():
    """The Pallas kernel's rule
    (tests/test_pallas_attention.py::test_tie_semantics_at_threshold)."""
    bank, v, kw, expect = _tie_case(C=4)
    ref = _pallas(bank, v, [0], [True], **kw)[0, 0]
    out = _port(bank, v, [0], [True], **kw).numpy()[0, 0]
    np.testing.assert_allclose(ref, expect, atol=1e-5)
    np.testing.assert_allclose(out, expect, atol=1e-5)


@pytest.mark.cuda
def test_kernel_tie_semantics_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    bank, v, kw, expect = _tie_case(C=16)
    out = _port(bank, v, [0], [True], device="cuda", **kw).cpu().numpy()[0, 0]
    np.testing.assert_allclose(out, expect, atol=1e-5)


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(name):
    """The CUDA kernel against the plain version on the same card inputs
    (C = 16: the kernel stages channels 16 at a time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    H, W, tile, radius, topk, fidx, valid, dup = CARD_CASES[name]
    rng = np.random.default_rng(sorted(CARD_CASES).index(name))
    C, Cv, T = 16, 7, len(fidx)
    bank = rng.standard_normal((max(fidx) + 2, H, W, C)).astype(np.float32)
    value = rng.random((T, H, W, Cv)).astype(np.float32)
    if dup:
        value[-1] = value[0]
    kw = dict(H=H, W=W, radius=radius, topk=topk, tile=tile)
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, W, radius, tile)
    kpad = k1.pad_key_bank(torch.from_numpy(bank).cuda(), radius, tile=tile)
    before = k1.launches
    out = _port(bank, value, fidx, valid, device="cuda", **kw)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.topk_attention_banked_plain(
        kpad[fidx[-1] + 1, halo:halo + Hp, halo:halo + Wp].contiguous(), kpad,
        torch.from_numpy(value).cuda(), frame_idx=fidx, key_valid=valid,
        temperature=0.07, **kw,
    )
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=TOL, atol=TOL)


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card_square(name):
    """K1 with the square window against the plain version on the card;
    5 value channels, as DAVIS VOS with 4 objects gives."""
    _card_or_skip()
    bank, value, fidx, valid, kw = _case_inputs(name, CARD_CASES, C=16, Cv=5)
    halo, Hp, Wp, _, _ = k1.bank_geometry(kw["H"], kw["W"], kw["radius"], kw["tile"])
    kpad = k1.pad_key_bank(torch.from_numpy(bank).cuda(), kw["radius"], tile=kw["tile"])
    before = k1.launches
    out = _port(bank, value, fidx, valid, device="cuda", mask_shape="square", **kw)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.topk_attention_banked_plain(
        kpad[fidx[-1] + 1, halo:halo + Hp, halo:halo + Wp].contiguous(), kpad,
        torch.from_numpy(value).cuda(), frame_idx=fidx, key_valid=valid,
        temperature=0.07, mask_shape="square", **kw,
    )
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(UNBANKED))
def test_unbanked_kernel_matches_plain_on_card(name):
    """K2 against its plain version on the card (C = 16, Cv = 5)."""
    _card_or_skip()
    normalize, mask_shape = UNBANKED[name]
    query, key, value, valid = _unbanked_inputs(
        sorted(UNBANKED).index(name), H=40, W=48, C=16)
    kw = dict(radius=6.0, temperature=0.07, topk=10, normalize=normalize, tile=16,
              mask_shape=mask_shape, key_valid=valid)
    args = [torch.from_numpy(x).cuda() for x in (query, key, value)]
    before = (k1.launches, k1.unbanked_launches)
    out = k1.topk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (k1.launches, k1.unbanked_launches) == (before[0], before[1] + 1)
    ref = k1.topk_attention_plain(*args, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=TOL, atol=TOL)
