"""K5: the profiling cut-downs of the port's unbanked top-k attention
(``topk_attention(..., debug_passes='a'|'ab')``) against the JAX package's
``fused_topk_attention(..., debug_passes=)``, whose Pallas kernel runs here in
interpret mode.

Cut 'a' is slot 0's masked affinities at the Pallas window columns 0..Cv-1
(window rows of wpad = round_up(win, 8) columns, so Cv > wpad crosses into
window row 1 and the Pallas over-pad); cut 'ab' is [thresh, mmax, z, frac,
n_above, cnt_at] zero-padded (or cut) to Cv.

Tolerances.  Masked affinities (<= NEG / 2) are equal, bit for bit: the
product term vanishes in NEG's rounding and the biases are summed in the
Pallas order.  The other affinities, thresh, mmax and frac within 1e-4 (as
tests/test_torch_port_attention.py: the sums run in another order); z within
1e-5 relative; n_above and cnt_at equal.  In 'high' and 'bfloat16' both
sides get the same pre-normalised float32 inputs (normalize=False): a value
whose norm is summed in another order can round to the neighbouring bf16
value (in 'high' its hi half, which moves the bf16x3 product by up to about
2^-17 relative); 'float32' normalises inside the entry.

On the card the kernel sums the affinities on the tensor cores in an order
the plain version cannot repeat: masked affinities stay equal bit for bit,
live ones agree within 2e-5 max|a|, and cut 'ab' agrees as above on every
row but near-tie rows (``near_tie_rows(..., stats=True)``: the plain k-th
largest live affinity within 1e-4 of the next one above or below), at most
0.1% of the rows (at least one).
"""

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.ops.cuda import topk_attention as k1

NEG = -1e30
TOL = 1e-4
Z_RTOL = 1e-5
MODES = ("float32", "high", "bfloat16")
# a tile row below the halo (query rows 8..), so cut 'a' carries real
# affinities; Cv = 20 > wpad = 16 crosses into window row 1 and the over-pad
BASE = dict(H=20, W=24, C=16, T=3, Cv=20)
KW = dict(radius=3.0, temperature=0.07, topk=5, tile=8)


def _inputs(H, W, C, T, Cv, seed=0, normalize=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((H, W, C)).astype(np.float32)
    k = rng.standard_normal((T, H, W, C)).astype(np.float32)
    v = rng.random((T, H, W, Cv)).astype(np.float32)
    if not normalize:
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
        k = (k / np.linalg.norm(k, axis=-1, keepdims=True)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, key_valid, passes, **kw):
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import fused_topk_attention

    return np.asarray(fused_topk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_valid=jnp.asarray(key_valid),
        interpret=True, debug_passes=passes, **kw))


def _port(q, k, v, key_valid, passes, device="cpu", plain=False, **kw):
    fn = k1.topk_attention_plain if plain else k1.topk_attention
    return fn(torch.from_numpy(q).to(device), torch.from_numpy(k).to(device),
              torch.from_numpy(v).to(device), key_valid=list(key_valid),
              debug_passes=passes, **kw).cpu().numpy()


def assert_cut_close(out, ref, passes):
    assert out.shape == ref.shape
    if passes == "a":
        masked = ref <= NEG / 2
        np.testing.assert_array_equal(out <= NEG / 2, masked)
        np.testing.assert_array_equal(out[masked], ref[masked])
        np.testing.assert_allclose(out[~masked], ref[~masked], rtol=TOL, atol=TOL)
        return
    n = min(out.shape[-1], k1.N_STATS)
    for ch in (0, 1, 3):  # thresh, mmax, frac
        if ch < n:
            np.testing.assert_allclose(out[..., ch], ref[..., ch], rtol=TOL, atol=TOL)
    if n > 2:
        np.testing.assert_allclose(out[..., 2], ref[..., 2], rtol=Z_RTOL)
    np.testing.assert_array_equal(out[..., 4:n], ref[..., 4:n])  # n_above, cnt_at
    np.testing.assert_array_equal(out[..., n:], 0.0)
    np.testing.assert_array_equal(ref[..., n:], 0.0)


def _case(mode, mask_shape, passes, key_valid=(True, True, True), **shape):
    sizes = {**BASE, **shape}
    normalize = mode == "float32"
    q, k, v = _inputs(**sizes, normalize=normalize)
    kw = dict(KW, normalize=normalize, mask_shape=mask_shape, compute_dtype=mode)
    ref = _jax(q, k, v, key_valid, passes, **kw)
    out = _port(q, k, v, key_valid, passes, **kw)
    return out, ref


@pytest.mark.parametrize("passes", ["a", "ab"])
@pytest.mark.parametrize("mask_shape", ["circle", "square"])
@pytest.mark.parametrize("mode", MODES)
def test_cut_matches_jax(mode, mask_shape, passes):
    out, ref = _case(mode, mask_shape, passes)
    assert_cut_close(out, ref, passes)
    if passes == "a":  # window row 1; row 0 below the halo (the strict
        live = ref > NEG / 2  # circle of radius 3 leaves it out)
        assert live[..., 16:].any()
        assert live[8:, :, :16].any() == (mask_shape == "square")


@pytest.mark.parametrize("passes", ["a", "ab"])
def test_cut_with_a_dead_slot_matches_jax(passes):
    """Slot 0 dead: cut 'a' emits its affinities with the slot's bias."""
    out, ref = _case("float32", "square", passes, key_valid=(False, True, True))
    assert_cut_close(out, ref, passes)
    if passes == "a":
        assert (ref <= NEG / 2).all()


def test_cut_ab_with_fewer_values_than_stats_matches_jax():
    """Cv = 5 < 6: the first five statistics, as the Pallas slice [:, :, :Cv]."""
    out, ref = _case("float32", "circle", "ab", Cv=5)
    assert out.shape[-1] == 5
    assert_cut_close(out, ref, "ab")


def test_cut_checks():
    q, k, v = _inputs(**BASE)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    with pytest.raises(ValueError, match="debug_passes"):
        k1.topk_attention(*args, debug_passes="b", **KW)
    with pytest.raises(ValueError, match="debug_passes"):
        k1.topk_attention_plain(*args, debug_passes="ac", **KW)
    wide = torch.zeros(BASE["T"], BASE["H"], BASE["W"], 257)
    with pytest.raises(ValueError, match="cut 'a'"):
        k1.topk_attention(args[0], args[1], wide, debug_passes="a", **KW)
    # the plain version counts nothing, and reset_launches clears the cuts
    before = dict(k1.cut_launches)
    k1.topk_attention(*args, debug_passes="ab", **KW)
    assert k1.cut_launches == before
    k1.cut_launches["a"] = 3
    k1.reset_launches()
    assert k1.cut_launches == {"a": 0, "ab": 0}


AFF_RTOL = 2e-5
NEAR_TIE_SHARE = 1e-3


def assert_cut_kernel_close(out, ref, passes, near_fn):
    """The kernel's cut against its plain version on the card (the module
    docstring); near_fn() gives the plain near-tie rows."""
    if passes == "a":
        masked = ref <= NEG / 2
        np.testing.assert_array_equal(out <= NEG / 2, masked)
        np.testing.assert_array_equal(out[masked], ref[masked])
        if (~masked).any():
            limit = AFF_RTOL * np.abs(ref[~masked]).max()
            assert np.abs(out[~masked] - ref[~masked]).max() <= limit
        return
    n = min(out.shape[-1], k1.N_STATS)
    d = np.abs(out - ref)
    bad = (d[..., [c for c in (0, 1, 3) if c < n]] > TOL).any(-1)
    if n > 2:
        bad |= d[..., 2] > Z_RTOL * np.abs(ref[..., 2])
    bad |= (out[..., 4:n] != ref[..., 4:n]).any(-1)
    if bad.any():
        assert not (bad & ~near_fn()).any()
        assert bad.sum() <= max(1, NEAR_TIE_SHARE * bad.size)
    np.testing.assert_array_equal(out[..., n:], 0.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("passes", ["a", "ab"])
@pytest.mark.parametrize("mask_shape", ["circle", "square"])
@pytest.mark.parametrize("mode", MODES)
def test_cut_kernel_matches_plain_on_card(card, mode, mask_shape, passes):
    q, k, v = _inputs(**BASE)
    for valid in ((True, True, True), (False, True, True)):
        kw = dict(KW, mask_shape=mask_shape, compute_dtype=mode)
        out = _port(q, k, v, valid, passes, device=card, **kw)
        ref = _port(q, k, v, valid, passes, device=card, plain=True, **kw)
        args = [torch.from_numpy(x).to(card) for x in (q, k, v)]
        assert_cut_kernel_close(out, ref, passes, lambda: k1.near_tie_rows_plain_unbanked(
            *args, key_valid=list(valid), stats=True, **kw).cpu().numpy())


@pytest.mark.cuda
def test_cut_launches_are_counted_apart(card):
    q, k, v = _inputs(**BASE)
    k1.reset_launches()
    for passes in ("a", "ab", "ab", "abc"):
        _port(q, k, v, (True,) * 3, passes, device=card, **KW)
    assert k1.cut_launches == {"a": 1, "ab": 2}
    assert k1.unbanked_launches == 1 and k1.mode_launches["float32"] == 1
    k1.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_ties_a_frame_in_two_slots_exactly_on_card(card, mode):
    """Frame 0 in slots 0 and 2 (the first propagation step): every key
    ties with its copy, so cut 'ab' counts an even number of keys above and
    at the threshold on every row, in every mode."""
    q, k, v = _inputs(**{**BASE, "Cv": 8})
    k = np.ascontiguousarray(np.broadcast_to(k[:1], k.shape))
    kw = dict(KW, topk=6, mask_shape="circle", compute_dtype=mode)
    out = _port(q, k, v, (True, False, True), "ab", device=card, **kw)
    assert (out[..., 4:6] % 2 == 0).all()
