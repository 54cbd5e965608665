"""The port's flash attention (ops/flash_attention.py) against the JAX
package's Pallas kernels in interpret mode (or, for `_flash_kernel`, its
plain reference), and its routing (ops/attention.py) against the JAX
package's gates, on the CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.ops import attention as jatt
from no_time_to_train_tpu.ops import flash_attention as jfa
from no_time_to_train_tpu_torch.ops import attention as att
from no_time_to_train_tpu_torch.ops import flash_attention as fa
from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion

# f32: the JAX package's anchors for these kernels in interpret mode
# (tests/test_flash_attention.py: onepass 5e-5 / 1e-4, window 2e-5 / 2e-5).
# bf16: both sides round the logits' softmax weights and the output to bf16
# at the same points from float32 sums taken in another order, so an output
# moves by at most a couple of units in bf16's last place (2**-8 relative):
# atol 4e-3 for outputs below 0.5, rtol 1/64 above.
F32_ONEPASS = dict(atol=5e-5, rtol=1e-4)
F32_WINDOW = dict(atol=2e-5, rtol=2e-5)
BF16_BAND = dict(atol=4e-3, rtol=1.0 / 64)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _interp_onepass(q, k, v):
    """JAX `_onepass_bnhd` in interpret mode, padded as `flash_sdpa_bnhd`
    pads: queries to the query block, keys to 128 (masked)."""
    n_q, n_k = q.shape[1], k.shape[1]
    n_kp = (n_k + 127) // 128 * 128
    bq = jfa._onepass_block_q(n_q, n_kp, jfa.ONEPASS_LOGITS_BYTES // 2)
    pad_q = [(0, 0), (0, (-n_q) % bq), (0, 0), (0, 0)]
    pad_k = [(0, 0), (0, n_kp - n_k), (0, 0), (0, 0)]
    out = jfa._onepass_bnhd(jnp.pad(q, pad_q), jnp.pad(k, pad_k),
                            jnp.pad(v, pad_k), bq, n_k, interpret=True)
    return out[:, :n_q]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,n_q,n_k", [(72, 256, 300), (64, 200, 384)])
def test_onepass_plain_matches_pallas_interpret(dtype, d, n_q, n_k):
    """D = 72 (Hiera) and 64 (DINO); 300 keys pad to 384 and are masked."""
    rng = np.random.default_rng(d + n_k)
    b, h = 2, 3
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) * s
               for n, s in ((n_q, 0.5), (n_k, 0.5), (n_k, 1.0)))
    jd = getattr(jnp, dtype)
    ref = _np(_interp_onepass(*(jnp.asarray(x, jd) for x in (q, k, v))))
    td = getattr(torch, dtype)
    got = fa.onepass_bnhd_plain(*(torch.as_tensor(x).to(td) for x in (q, k, v)))
    assert got.dtype == td and tuple(got.shape) == (b, n_q, h, d)
    tol = F32_ONEPASS if dtype == "float32" else BF16_BAND
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,d,win,nw", [(2, 72, 64, 4), (4, 72, 16, 8),
                                            (2, 72, 256, 2), (1, 96, 196, 2),
                                            (2, 96, 49, 4), (2, 56, 196, 2)])
def test_window_plain_matches_pallas_interpret(dtype, heads, d, win, nw):
    """The Hiera-L window shapes: 64 tokens x 2 heads, 16 x 4, 256 x 2; and
    the smaller topologies' windows of 196 and 49 tokens at head dims 96
    and 56."""
    rng = np.random.default_rng(win)
    c = heads * d
    qkv = rng.standard_normal((1, nw * win, 3 * c)).astype(np.float32) * 0.5
    ref = _np(jfa.flash_sdpa_window_qkv(jnp.asarray(qkv, getattr(jnp, dtype)),
                                        heads=heads, win=win, interpret=True))
    got = fa.window_qkv_plain(torch.as_tensor(qkv).to(getattr(torch, dtype)),
                              heads, win)
    tol = F32_WINDOW if dtype == "float32" else BF16_BAND
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


F32_MASKED = dict(atol=5e-5, rtol=1e-4)   # tests/test_flash_attention.py:453


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,n_q,n_k", [(256, 256, 300), (72, 200, 384)])
def test_flash_bh_plain_matches_onepass_bh_interpret(dtype, d, n_q, n_k):
    """`flash_bh_plain` against the JAX `_onepass_bh` kernel in interpret
    mode, padded as `flash_sdpa` pads: D = 256 (memory attention) and 72;
    300 keys pad to 384 and are masked."""
    rng = np.random.default_rng(d + n_k)
    b, h = 2, 2
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) * s
               for n, s in ((n_q, 0.3), (n_k, 0.3), (n_k, 1.0)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    n_kp = (n_k + 127) // 128 * 128
    bq = jfa._onepass_block_q(n_q, n_kp)
    pad = lambda x, n: jnp.pad(jnp.asarray(x, jd).reshape(b * h, -1, d),
                               [(0, 0), (0, n), (0, 0)])
    ref = jfa._onepass_bh(pad(q, (-n_q) % bq), pad(k, n_kp - n_k),
                          pad(v, n_kp - n_k), bq, n_k, interpret=True)
    ref = _np(ref[:, :n_q]).reshape(b, h, n_q, d)
    got = fa.flash_bh_plain(*(torch.as_tensor(x).to(td) for x in (q, k, v)))
    assert got.dtype == td and tuple(got.shape) == (b, h, n_q, d)
    tol = F32_ONEPASS if dtype == "float32" else BF16_BAND
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_flash_bh_plain_matches_the_online_kernels_reference():
    """The JAX `_flash_kernel` (keys past 4608) does not run off the TPU;
    its plain reference `_xla_sdpa` stands for it, at 4700 keys and D = 72,
    on 3-D operands."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 130, 72)).astype(np.float32) * 0.5
    k = rng.standard_normal((2, 4700, 72)).astype(np.float32) * 0.5
    v = rng.standard_normal((2, 4700, 72)).astype(np.float32)
    ref = _np(jatt._xla_sdpa(*(jnp.asarray(x) for x in (q, k, v))))
    got = fa.flash_bh_plain(*(torch.as_tensor(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, **F32_ONEPASS)


def _interp_onepass_bh(q, k, v, jd):
    """JAX `_onepass_bh` in interpret mode on [B, H, N, D] numpy operands,
    padded as `flash_sdpa` pads them."""
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    n_kp = (n_k + 127) // 128 * 128
    bq = jfa._onepass_block_q(n_q, n_kp)
    pad = lambda x, n: jnp.pad(jnp.asarray(x, jd).reshape(b * h, -1, d),
                               [(0, 0), (0, n), (0, 0)])
    ref = jfa._onepass_bh(pad(q, (-n_q) % bq), pad(k, n_kp - n_k),
                          pad(v, n_kp - n_k), bq, n_k, interpret=True)
    return _np(ref[:, :n_q]).reshape(b, h, n_q, d)


# (n_q, n_k, d, splits, tile): ragged sizes; 130 keys are 3 tiles of 64, so
# the 4th split is empty; 64 keys are 1 tile, so the 2nd split is empty; 333
# keys leave the 3rd split a tail of 13 keys; 1000 keys in tiles of 16
SPLIT_CASES = [(70, 130, 16, 4, 64), (33, 333, 24, 3, 64), (5, 64, 8, 2, 64),
               (9, 65, 8, 1, 64), (40, 520, 256, 4, 64), (1, 200, 72, 2, 64),
               (50, 1000, 32, 4, 16)]


@pytest.mark.parametrize("n_q,n_k,d,splits,tile", SPLIT_CASES)
def test_split_merge_plain_matches_unsplit(n_q, n_k, d, splits, tile):
    """The key-split arithmetic of the bf16 kernels (partial O, maximum and
    sum per run of whole key tiles, merged in order) against the unsplit
    plain version in float32: the same sums in another order, 1e-5."""
    rng = np.random.default_rng(n_k + splits)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 3, n, d)).astype(
        np.float32) * s) for n, s in ((n_q, 1.0), (n_k, 1.0), (n_k, 1.0)))
    got = fa.flash_bh_split_plain(q, k, v, splits, tile)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, fa.flash_bh_plain(q, k, v), rtol=1e-5,
                               atol=1e-5)


def test_merge_splits_plain_ignores_a_split_without_keys():
    """A split that saw no key (maximum -inf, sum 0, O 0) changes nothing,
    wherever it stands, and one split alone is plain normalisation."""
    rng = np.random.default_rng(3)
    o, l = (torch.as_tensor(rng.random(s).astype(np.float32) + 0.5)
            for s in ((2, 7, 8), (2, 7, 1)))
    m = torch.as_tensor(rng.standard_normal((2, 7, 1)).astype(np.float32))
    empty = (torch.zeros_like(o), torch.full_like(m, -np.inf),
             torch.zeros_like(l))
    want = o / l
    for parts in ([(o, m, l)], [empty, (o, m, l)], [(o, m, l), empty, empty]):
        torch.testing.assert_close(fa.merge_splits_plain(parts), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,n_q,n_k,splits", [(256, 256, 300, 3),
                                              (72, 200, 384, 4)])
def test_split_merge_plain_matches_onepass_bh_interpret(dtype, d, n_q, n_k,
                                                        splits):
    """The split arithmetic against the JAX `_onepass_bh` kernel in
    interpret mode (the kernel `flash_sdpa` reaches at these sizes). In
    bf16 the split version rounds the unnormalised weights and divides
    after the value product, the TPU kernel normalises first: the same
    relative rounding, inside the bf16 band."""
    rng = np.random.default_rng(d + n_k)
    q, k, v = (rng.standard_normal((2, 2, n, d)).astype(np.float32) * s
               for n, s in ((n_q, 0.3), (n_k, 0.3), (n_k, 1.0)))
    ref = _interp_onepass_bh(q, k, v, getattr(jnp, dtype))
    td = getattr(torch, dtype)
    got = fa.flash_bh_split_plain(
        *(torch.as_tensor(x).to(td) for x in (q, k, v)), splits)
    assert got.dtype == td
    tol = F32_ONEPASS if dtype == "float32" else BF16_BAND
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


# the shapes of the models' calls and what each must give
@pytest.mark.parametrize("n_q,n_k,d,want", [
    (4096, 4096, 256, 4), (4096, 28736, 256, 4), (1370, 1370, 64, 1),
    (4096, 4096, 72, 1), (8192, 8192, 72, 1), (4096, 4096, 128, 1),
    (4096, 500, 256, 1), (4096, 1024, 256, 2), (128, 4096, 256, 4),
    (8448, 4096, 256, 2), (8449, 4096, 256, 1), (20000, 4096, 256, 1)])
def test_key_splits_rule(n_q, n_k, d, want):
    """The split count is a function of (n_q, n_k, d) alone: one run up to
    D = 128; at D > 128 as many runs as spread the 128-row query tiles over
    132 SMs, at most 4, each of at least 8 key tiles of 64."""
    assert fa.key_splits(n_q, n_k, d) == want
    assert 1 <= want <= fa.MAX_SPLITS


def test_split_scratch_follows_the_rule_and_the_dtype():
    """bf16 operands get the rule's split count and float32 scratch for the
    partial results; float32 operands take one split and no scratch; a
    forced count is honoured up to MAX_SPLITS."""
    q = torch.zeros(1, dtype=torch.bfloat16)
    n, part_o, part_ml = fa._split_args(q, 6, 512, 4096, 256, None)
    assert n == fa.key_splits(512, 4096, 256) == 4
    assert part_o.shape == (24, 512, 256) and part_o.dtype == torch.float32
    assert part_ml.shape == (24, 512, 2) and part_ml.dtype == torch.float32
    assert fa._split_args(q, 6, 512, 4096, 64, None) == (1, None, None)
    assert fa._split_args(q, 2, 10, 100, 64, 3)[0] == 3
    assert fa._split_args(q.float(), 6, 512, 4096, 256, None) == (1, None, None)
    with pytest.raises(ValueError, match="key splits"):
        fa._split_args(q, 2, 10, 100, 64, fa.MAX_SPLITS + 1)
    with pytest.raises(ValueError, match="float32"):
        fa._split_args(q.float(), 2, 10, 100, 64, 2)


# (entry, D, dtypes of q and k, the refusal's words)
REFUSALS = [("bh", 12, ("bfloat16", "bfloat16"), "16-byte pieces"),
            ("bh", 6, ("float32", "float32"), "16-byte pieces"),
            ("bh", 264, ("bfloat16", "bfloat16"), "16-byte pieces"),
            ("bh", 64, ("bfloat16", "float32"), "share one dtype"),
            ("bh", 64, ("float16", "float16"), "float32 or bfloat16"),
            ("bnhd", 12, ("bfloat16", "bfloat16"), "16-byte pieces"),
            ("bnhd", 264, ("float32", "float32"), "16-byte pieces"),
            ("bnhd", 64, ("float32", "bfloat16"), "share one dtype"),
            ("bnhd", 64, ("float16", "float16"), "float32 or bfloat16")]


@pytest.mark.parametrize("entry,d,dtypes,words", REFUSALS)
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(entry, d, dtypes,
                                                             words):
    """The checks in front of both tiles' launches: a head dim that is not
    whole 16-byte pieces or is wider than 256, mixed dtypes, and a dtype
    other than float32 / bfloat16 raise before any launch."""
    q, k = (torch.zeros((1, 2, 20, d) if entry == "bh" else (1, 20, 2, d),
                        dtype=getattr(torch, dt)) for dt in dtypes)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match=words):
        if entry == "bh":
            fa._launch_flash("flash_bh", q, k, k, None)
        else:
            fa._check_bnhd(q, k, k)
    assert fa.LAUNCHES == before


def _masked_case(rng, b, h, n_q, n_k, d):
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) * 0.3
               for n in (n_q, n_k, n_k))
    valid = rng.random((b, n_k)) < 0.5
    valid[0, :128] = False           # a whole first key block masked ...
    valid[0, 128] = True             # ... and the first valid key after it
    return q, k, v, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_masked_plain_matches_pallas_interpret(dtype):
    """`flash_masked_plain` against the JAX `flash_sdpa_masked` in interpret
    mode: a fully masked prefix of key blocks heals at the first valid key,
    ragged queries and keys are padded and masked there."""
    rng = np.random.default_rng(21)
    q, k, v, valid = _masked_case(rng, 2, 2, 50, 300, 32)
    valid[1, :] = np.arange(300) < 200
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = _np(jfa.flash_sdpa_masked(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(valid),
        block_q=16, block_k=128, interpret=True))
    got = fa.flash_masked_plain(*(torch.as_tensor(x).to(td) for x in (q, k, v)),
                                torch.as_tensor(valid))
    assert got.dtype == td
    tol = F32_MASKED if dtype == "float32" else BF16_BAND
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_flash_masked_plain_all_masked_row_is_the_mean_of_v():
    """A batch element with every key masked returns the mean of v over its
    300 real keys, as the JAX package's plain masked softmax does. The
    Pallas kernel agrees where the keys fill its blocks (256 keys in blocks
    of 128) and would also count its padding otherwise; the port follows
    the plain path."""
    rng = np.random.default_rng(22)
    for n_k in (300, 256):
        q, k, v, valid = _masked_case(rng, 2, 1, 40, n_k, 16)
        valid[1, :] = False
        t = [torch.as_tensor(x) for x in (q, k, v)]
        got = fa.flash_masked_plain(*t, torch.as_tensor(valid)).numpy()
        want = _np(jatt._xla_sdpa(*(jnp.asarray(x) for x in (q, k, v)),
                                  mask=jnp.asarray(valid)[:, None, None, :]))
        np.testing.assert_allclose(got, want, **F32_MASKED)
        np.testing.assert_allclose(
            got[1], np.broadcast_to(v[1].mean(axis=-2, keepdims=True),
                                    got[1].shape), rtol=1e-5, atol=1e-6)
    ref = _np(jfa.flash_sdpa_masked(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid),
        block_q=8, block_k=128, interpret=True))
    np.testing.assert_allclose(got, ref, **F32_MASKED)


def _mask_of(kind, b, n_k, rng):
    """Key masks [b, n_k] for the tile list and the key runs (tiles of 64
    keys): "ring" whole rows of 128 keys valid or not; "prefix" the first
    tiles masked; "all_masked" one element with no valid key beside a
    random one; "single" one valid key in the whole element; "last_partial"
    valid keys in the last, partial tile only; "alternate" every other tile
    fully masked."""
    valid = rng.random((b, n_k)) < 0.6
    if kind == "ring":
        rows = rng.random((b, -(-n_k // 128))) < 0.5
        rows[:, 0] = True
        valid = np.repeat(rows, 128, axis=1)[:, :n_k]
    elif kind == "prefix":
        valid[0, :200] = False
    elif kind == "all_masked":
        valid[-1] = False
    elif kind == "single":
        valid[:] = False
        valid[np.arange(b), rng.integers(0, n_k, b)] = True
    elif kind == "last_partial":
        valid[:, :n_k // 64 * 64] = False
        valid[:, -1] = True
    elif kind == "alternate":
        valid[:, (np.arange(n_k) // 64) % 2 == 1] = False
    return valid


MASK_KINDS = ["ring", "prefix", "all_masked", "single", "last_partial",
              "alternate"]


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_masked_tile_list_plain(kind):
    """The taken tiles are those with a valid key, in ascending order, then
    -1; the count is their number, and 0 for an element with no valid key."""
    rng = np.random.default_rng(len(kind))
    b, n_k, tile = 3, 700, 64
    valid = _mask_of(kind, b, n_k, rng)
    tiles, count = fa.masked_tile_list_plain(torch.as_tensor(valid), tile)
    n_tiles = -(-n_k // tile)
    assert tiles.dtype == torch.int32 and tuple(tiles.shape) == (b, n_tiles)
    assert count.dtype == torch.int32 and tuple(count.shape) == (b,)
    for i in range(b):
        want = [t for t in range(n_tiles)
                if valid[i, t * tile:(t + 1) * tile].any()]
        assert int(count[i]) == len(want)
        assert tiles[i].tolist() == want + [-1] * (n_tiles - len(want))
    if kind == "all_masked":
        assert int(count[-1]) == 0
    if kind == "single":
        assert count.tolist() == [1] * b
    if kind == "last_partial":
        assert tiles[:, 0].tolist() == [n_tiles - 1] * b


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_masked_split_plain_matches_unsplit(kind, splits):
    """The masked kernel's arithmetic (taken tiles in `splits` runs, base-2
    exponent, merge) equals one softmax over the whole masked key range; a
    "single" mask leaves all runs but one empty."""
    rng = np.random.default_rng(splits + len(kind))
    b, h, n_q, n_k, d = 2, 2, 37, 700, 16
    q, k, v = (torch.as_tensor(rng.standard_normal((b, h, n, d))
                               .astype(np.float32) * 0.5)
               for n in (n_q, n_k, n_k))
    valid = torch.as_tensor(_mask_of(kind, b, n_k, rng))
    got = fa.flash_masked_split_plain(q, k, v, valid, splits)
    ref = fa.flash_masked_plain(q, k, v, valid)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32_MASKED)
    if kind == "all_masked":
        np.testing.assert_allclose(
            got[-1].numpy(), np.broadcast_to(
                v[-1].mean(dim=-2, keepdim=True).numpy(), got[-1].shape),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 4])
def test_masked_split_plain_matches_pallas_interpret(dtype, splits):
    """`flash_masked_split_plain` against the JAX `flash_sdpa_masked` in
    interpret mode, on the case of
    `test_flash_masked_plain_matches_pallas_interpret`."""
    rng = np.random.default_rng(21)
    q, k, v, valid = _masked_case(rng, 2, 2, 50, 300, 32)
    valid[1, :] = np.arange(300) < 200
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = _np(jfa.flash_sdpa_masked(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(valid),
        block_q=16, block_k=128, interpret=True))
    got = fa.flash_masked_split_plain(
        *(torch.as_tensor(x).to(td) for x in (q, k, v)),
        torch.as_tensor(valid), splits)
    assert got.dtype == td
    tol = F32_MASKED if dtype == "float32" else BF16_BAND
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_masked_split_plain_batch_equals_its_elements_alone():
    """An element's taken tiles and runs depend on its own mask only: a
    batch of 3 different masks equals each element alone, exactly."""
    rng = np.random.default_rng(5)
    b, h, n_q, n_k, d = 3, 2, 20, 450, 16
    q, k, v = (torch.as_tensor(rng.standard_normal((b, h, n, d))
                               .astype(np.float32))
               for n in (n_q, n_k, n_k))
    valid = torch.as_tensor(np.stack([
        _mask_of(kind, 1, n_k, rng)[0]
        for kind in ("ring", "single", "all_masked")]))
    whole = fa.flash_masked_split_plain(q, k, v, valid, 3)
    for i in range(b):
        alone = fa.flash_masked_split_plain(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], valid[i:i + 1], 3)
        assert torch.equal(whole[i:i + 1], alone)


def test_second_implementations_refuse_a_cpu_tensor():
    """The `_wmma` entries and the pre-pass alone exist on the card only:
    a CPU tensor raises, and nothing is counted."""
    before = dict(fa.LAUNCHES)
    qkv = torch.zeros((1, 32, 48))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_sdpa_window_qkv_wmma(qkv, 2, 16)
    q = torch.zeros((1, 2, 20, 8))
    valid = torch.ones((1, 20), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_sdpa_masked_wmma(q, q, q, valid)
    with pytest.raises(ValueError, match="CUDA"):
        fa.masked_tile_list(valid)
    assert fa.LAUNCHES == before


def test_wrappers_take_the_plain_versions_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; a window
    count that does not divide the tokens is refused."""
    before = dict(fa.LAUNCHES)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((1, 40, 2, 8)), dtype=torch.float32)
    torch.testing.assert_close(fa.flash_sdpa_bnhd(q, q, q),
                               fa.onepass_bnhd_plain(q, q, q), rtol=0, atol=0)
    qkv = torch.as_tensor(rng.standard_normal((2, 32, 48)), dtype=torch.float32)
    torch.testing.assert_close(fa.flash_sdpa_window_qkv(qkv, 2, 16),
                               fa.window_qkv_plain(qkv, 2, 16), rtol=0, atol=0)
    k = torch.as_tensor(rng.standard_normal((1, 2, 50, 8)), dtype=torch.float32)
    qh = q.transpose(1, 2)
    torch.testing.assert_close(fa.flash_sdpa(qh, k, k),
                               fa.flash_bh_plain(qh, k, k), rtol=0, atol=0)
    valid = torch.as_tensor(rng.random((1, 50)) < 0.5)
    torch.testing.assert_close(fa.flash_sdpa_masked(qh, k, k, valid),
                               fa.flash_masked_plain(qh, k, k, valid),
                               rtol=0, atol=0)
    assert fa.LAUNCHES == before
    with pytest.raises(ValueError):
        fa.flash_sdpa_window_qkv(qkv, 2, 24)
    with pytest.raises(ValueError):
        fa.flash_sdpa_masked(qh, k, k, valid.float())


class _Calls:
    """Wraps a plain version and records the shapes it is called with."""

    def __init__(self, fn):
        self.fn, self.shapes = fn, []

    def __call__(self, x, *args, **kw):
        self.shapes.append(tuple(x.shape))
        return self.fn(x, *args, **kw)


@pytest.fixture
def port_calls(monkeypatch):
    calls = {"bnhd": _Calls(fa.onepass_bnhd_plain),
             "window": _Calls(fa.window_qkv_plain),
             "bh": _Calls(fa.flash_bh_plain),
             "masked": _Calls(fa.flash_masked_plain)}
    monkeypatch.setattr(fa, "onepass_bnhd_plain", calls["bnhd"])
    monkeypatch.setattr(fa, "window_qkv_plain", calls["window"])
    monkeypatch.setattr(fa, "flash_bh_plain", calls["bh"])
    monkeypatch.setattr(fa, "flash_masked_plain", calls["masked"])
    return calls


@pytest.fixture
def jax_routes(monkeypatch):
    """The JAX package's routing as it runs on a TPU, with every Pallas
    kernel replaced by a recorder that returns zeros."""
    taken = []

    def record(name):
        def kernel(q, *args, **kw):
            taken.append(name)
            return jnp.zeros(q.shape, q.dtype)
        return kernel

    for name in ("_onepass_bnhd", "_onepass_bh", "_flash_bh"):
        monkeypatch.setattr(jfa, name, record(name))

    def window(qkv, *, heads, win):
        taken.append("window")
        return qkv[..., :qkv.shape[-1] // 3]
    monkeypatch.setattr(jfa, "flash_sdpa_window_qkv", window)

    def masked(q, k, v, key_valid):
        taken.append("masked")
        return jnp.zeros(q.shape, q.dtype)
    monkeypatch.setattr(jfa, "flash_sdpa_masked", masked)
    monkeypatch.setattr(jatt, "_default_device_is_cpu", lambda: False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return taken


# (n_q, n_k, 4-D): both gates of 512 tokens, the single-pass range of 4608
# keys padded to 128, the resident range of 12288, and a 3-D operand
BNHD_SHAPES = [(511, 600, True), (600, 511, True), (512, 512, True),
               (530, 1370, True), (512, 4608, True), (520, 4609, True),
               (512, 12288, True), (512, 12289, True), (600, 600, False)]


@pytest.mark.parametrize("n_q,n_k,four_d", BNHD_SHAPES)
def test_sdpa_bnhd_routes_as_jax(n_q, n_k, four_d, port_calls, jax_routes):
    """Under "pallas" the port takes kernel 9 exactly where the JAX package
    takes `_onepass_bnhd`, transposes into `flash_sdpa` where it takes
    `_onepass_bh` / `_flash_bh` (3-D operands, or keys past the single-pass
    range: these shapes raised NotImplementedError before the kernel was
    ported and are accepted now), and runs the plain formula where it runs
    XLA. Under "xla" and inside no_fusion() neither side takes a kernel."""
    rng = np.random.default_rng(n_k)
    lead = (1,) if four_d else ()
    q = rng.standard_normal(lead + (n_q, 1, 8)).astype(np.float32)
    k = rng.standard_normal(lead + (n_k, 1, 8)).astype(np.float32)
    jatt.sdpa_bnhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                   impl="pallas")
    tq, tk = torch.as_tensor(q), torch.as_tensor(k)
    out = att.sdpa_bnhd(tq, tk, tk, "pallas")
    assert tuple(out.shape) == q.shape
    ref = att.sdpa_bnhd(tq, tk, tk, "xla")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=5e-5)
    want = {"bnhd": [q.shape] if jax_routes == ["_onepass_bnhd"] else [],
            "bh": ([lead + (1, n_q, 8)]
                   if jax_routes in (["_onepass_bh"], ["_flash_bh"]) else []),
            "window": [], "masked": []}
    assert {k_: c.shapes for k_, c in port_calls.items()} == want
    jax_routes.clear()
    jatt.sdpa_bnhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), impl="xla")
    with no_fusion():
        att.sdpa_bnhd(tq, tk, tk, "pallas")
    assert jax_routes == []
    assert {k_: c.shapes for k_, c in port_calls.items()} == want


# (n_q, n_k, q dims, mask: None, "col" [B, 1, 1, Nk] bool, "full"
# [B, 1, Nq, Nk] bool, "float" [B, 1, 1, Nk] float32)
SDPA_CASES = [(511, 600, 4, None), (600, 511, 4, None), (512, 512, 4, None),
              (512, 4700, 4, None), (512, 12288, 3, None),
              (512, 12289, 4, None), (512, 4609, 4, "col"),
              (512, 4608, 4, "col"), (511, 4700, 4, "col"),
              (512, 4700, 4, "full"), (512, 4700, 5, "col")]


@pytest.mark.parametrize("n_q,n_k,dims,mask_kind", SDPA_CASES)
def test_sdpa_routes_as_jax(n_q, n_k, dims, mask_kind, port_calls,
                            jax_routes):
    """`sdpa` under "pallas": unmasked sequences of at least 512 tokens take
    `flash_sdpa` up to 12288 padded keys; a bool key-column mask
    [B, 1, 1, Nk] on 4-D operands over more than 4608 keys takes
    `flash_sdpa_masked`; every other shape is the plain formula, as in the
    JAX package. The decoder's call without an impl never takes a kernel."""
    rng = np.random.default_rng(n_q + n_k)
    lead = {3: (), 4: (2,), 5: (2, 1)}[dims]
    q = rng.standard_normal(lead + (1, n_q, 8)).astype(np.float32)
    k = rng.standard_normal(lead + (1, n_k, 8)).astype(np.float32)
    mask = None
    if mask_kind == "col":
        mask = rng.random((2,) + (1,) * (dims - 2) + (n_k,)) < 0.6
    elif mask_kind == "full":
        mask = rng.random((2, 1, n_q, n_k)) < 0.6
    jm = None if mask is None else jnp.asarray(mask)
    jatt.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), mask=jm,
              impl="pallas")
    tq, tk = torch.as_tensor(q), torch.as_tensor(k)
    tm = None if mask is None else torch.as_tensor(mask)
    out = att.sdpa(tq, tk, tk, mask=tm, impl="pallas")
    torch.testing.assert_close(out, att.sdpa(tq, tk, tk, mask=tm),
                               rtol=1e-4, atol=5e-5)
    route = {(): None, ("_onepass_bh",): "bh", ("_flash_bh",): "bh",
             ("masked",): "masked"}[tuple(jax_routes)]
    want = {name: ([q.shape] if name == route else [])
            for name in port_calls}
    assert {k_: c.shapes for k_, c in port_calls.items()} == want
    with no_fusion():
        att.sdpa(tq, tk, tk, mask=tm, impl="pallas")
    att.sdpa(tq, tk, tk, mask=tm, impl="xla")
    assert {k_: c.shapes for k_, c in port_calls.items()} == want


def test_sdpa_masked_gate_needs_a_bool_mask(port_calls):
    """A float mask of the key-column shape stays on the plain path in the
    JAX package (its gate tests the dtype); the port's plain formula takes
    bool masks only, so the port refuses it rather than guess."""
    q = torch.zeros(1, 1, 512, 8)
    k = torch.zeros(1, 1, 4700, 8)
    with pytest.raises((RuntimeError, TypeError)):
        att.sdpa(q, k, k, mask=torch.ones(1, 1, 1, 4700), impl="pallas")
    assert port_calls["masked"].shapes == []


# (b, t, win, min_tokens, impl)
WINDOW_CASES = [(8, 64, 64, 256, "pallas"), (8, 64, 64, 4096, "pallas"),
                (64, 64, 64, 4096, "pallas"), (8, 64, 32, 256, "pallas"),
                (256, 16, 16, 4096, "pallas"), (16, 256, 256, 4096, "pallas"),
                (16, 64, 64, 4096, "pallas"), (8, 64, 64, 256, "xla")]


@pytest.mark.parametrize("b,t,win,min_tokens,impl", WINDOW_CASES)
def test_window_sdpa_qkv_routes_as_jax(b, t, win, min_tokens, impl,
                                       port_calls, jax_routes):
    """The window kernel is taken where the JAX gate opens (b * t >=
    min_tokens, win == t, "pallas"), with the windows flattened to one
    window-major stream, and declined elsewhere and inside no_fusion()."""
    qkv = np.random.default_rng(b * t).standard_normal(
        (b, t, 3 * 16)).astype(np.float32)
    j = jatt.window_sdpa_qkv(jnp.asarray(qkv), heads=2, win=win, impl=impl,
                             min_tokens=min_tokens)
    tq = torch.as_tensor(qkv)
    got = att.window_sdpa_qkv(tq, 2, win, impl, min_tokens=min_tokens)
    assert (got is None) == (j is None)
    if j is not None:
        assert jax_routes == ["window"]
        assert port_calls["window"].shapes == [(1, b * t, 48)]
        assert tuple(got.shape) == (b, t, 16)
        torch.testing.assert_close(got, fa.window_qkv_plain.fn(
            tq.reshape(1, b * t, 48), 2, win).reshape(b, t, 16))
    else:
        assert jax_routes == [] and port_calls["window"].shapes == []
    with no_fusion():
        assert att.window_sdpa_qkv(tq, 2, win, impl,
                                   min_tokens=min_tokens) is None
