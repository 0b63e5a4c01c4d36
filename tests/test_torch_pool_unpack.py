"""The arithmetic of the slab-pool sampler (csrc/trilinear.cuh, PoolSampler),
replayed in numpy float32 and uint32 on the CPU, against the plain sampler
``ops/sampling.py::sample_trilinear_slab_pool``.

The kernel turns a pool word into its two taps without shifts or
int-to-float conversions.  A pair16 word: one byte permute
(``__byte_perm(word, 0x4B000000, 0x7440 + byte)``) makes the float 2^23 +
byte, and subtracting 2^23 leaves the byte, then times 1/255; which byte is
chosen by the parity of x0 (the word holds pair x0 in its low half for x0
even, its high half for x0 odd).  A narrow pair value p: split in the float
domain, hi = truncf(p / 256) and lo = p - hi * 256, each times 1/255.  At the
low x face (i0x < 0) the high byte serves both taps.  Word offsets are
formed in uint32 from a per-ray cursor's word base (16 slot - 8 block) * Y
* words_per_row, a sum mod 2^32.  Each replay must give the
plain sampler's floats bit for bit: over all 65 536 pair values and both x
parities, and over marches of positions through a pool with empty, shared
and out-of-range slots.

These are design checks of the arithmetic, not of the kernel: the replays
rewrite PoolSampler's byte selection, offset and cursor arithmetic by hand
and never run trilinear.cuh, so an edit to the sampler must be made here
too, by hand.  What guards the kernel itself are the ``cuda``-marked edge
tests of ``tests/test_torch_pooled_kernel.py``, which hold B6-B9 and the
pooled shade bit-equal to the plain versions and the dense kernels on the
card.
"""
import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch.io.synthetic import turbulence_volume
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK
from volumerenderer_tpu_torch.ops.sampling import sample_trilinear_slab_pool

F32 = np.float32
INV255 = F32(1.0) / F32(255.0)
TWO23 = F32(8388608.0)
PAIRS = np.arange(65536, dtype=np.uint32)


def byte_perm(x, y, selector):
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: result byte i is byte
    (s >> 4i) & 7 of the 8 bytes (y << 32) | x."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    s = np.asarray(selector, np.uint64)
    out = np.zeros(np.broadcast(v, s).shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((v >> (np.uint64(8) * sel)) & np.uint64(255)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def pool_tap(word, selector):
    """trilinear.cuh::pool_tap: (float(0x4B0000bb) - 2^23) * (1/255)."""
    magic = byte_perm(word, np.uint32(0x4B000000), selector).view(F32)
    return (magic - TWO23) * INV255


def narrow_taps(p, low_edge):
    """trilinear.cuh::pair_taps of a narrow pair value p: hi = truncf(p *
    (1/256)), lo = p - hi * 256, each times 1/255; hi twice at the low face."""
    p = np.asarray(p, F32)
    h = np.trunc(p * F32(1.0 / 256.0))
    c0 = h * INV255
    return c0, np.where(low_edge, c0, (p - h * F32(256.0)) * INV255)


def selectors(x0, i0x):
    """The pair16 selectors of the high byte (s[x0]) and of the x + 1 tap."""
    lo = np.uint32(0x7440) + ((np.asarray(x0, np.uint32) & np.uint32(1)) << np.uint32(1))
    hi = lo + np.uint32(1)
    return hi, np.where(np.asarray(i0x) < 0, hi, lo).astype(np.uint32)


def plain_taps(p16, low_edge):
    """sample_trilinear_slab_pool's taps of a pair value: (p16 >> 8) / 255 and
    (p16 & 255) / 255, the high one at the low x face."""
    t = torch.as_tensor(p16.astype(np.int32))
    c0 = (t >> 8).to(torch.float32) * (1.0 / 255.0)
    c1 = (t & 255).to(torch.float32) * (1.0 / 255.0)
    return c0.numpy(), torch.where(torch.as_tensor(low_edge), c0, c1).numpy()


def test_magic_number_byte_conversion_is_exact():
    b = np.arange(256, dtype=np.uint32)
    magic = (np.uint32(0x4B000000) | b).view(F32) - TWO23
    assert np.array_equal(magic, b.astype(F32))
    assert np.array_equal(magic * INV255, b.astype(F32) * INV255)


@pytest.mark.parametrize("parity", [0, 1])
def test_pair16_byte_perm_selection_all_pairs(parity):
    # pair x0 in the low (x0 even) or high (x0 odd) half of its word, another
    # pair in the other half
    other = np.random.default_rng(parity).permutation(PAIRS)
    low, high = (PAIRS, other) if parity == 0 else (other, PAIRS)
    word = low | (high << np.uint32(16))
    x0 = np.full(PAIRS.shape, 6 + parity)
    for low_edge in (False, True):
        hi, lo = selectors(x0, np.full(PAIRS.shape, -1 if low_edge else 6 + parity))
        want0, want1 = plain_taps(PAIRS, np.full(PAIRS.shape, low_edge))
        assert np.array_equal(pool_tap(word, hi).view(np.uint32), want0.view(np.uint32))
        assert np.array_equal(pool_tap(word, lo).view(np.uint32), want1.view(np.uint32))


@pytest.mark.parametrize("low_edge", [False, True])
def test_narrow_float_split_all_pairs(low_edge):
    # the split is exact: hi and lo are the pair's bytes as floats
    p = PAIRS.astype(F32)
    h = np.trunc(p * F32(1.0 / 256.0))
    assert np.array_equal(h, (PAIRS >> np.uint32(8)).astype(F32))
    assert np.array_equal(p - h * F32(256.0), (PAIRS & np.uint32(255)).astype(F32))
    got0, got1 = narrow_taps(p, np.full(PAIRS.shape, low_edge))
    want0, want1 = plain_taps(PAIRS, np.full(PAIRS.shape, low_edge))
    assert np.array_equal(got0.view(np.uint32), want0.view(np.uint32))
    assert np.array_equal(got1.view(np.uint32), want1.view(np.uint32))


def texel(u, n):
    t = u * F32(n) - F32(0.5)
    i = np.floor(t)
    return i.astype(np.int64), t - i


def replay_march(pool, slab_map, dims, entry, step, n_steps):
    """PoolSampler over n_steps positions of each ray (entry + k additions of
    step), in numpy: uint32 word offsets from a per-ray cursor, the word, its
    two taps and the seven lerps.  Returns (n_steps, N) samples and the
    positions."""
    X, Y, Z = dims
    pair16 = pool.dtype == np.int32
    wpr = np.uint32(X // 2 if pair16 else X)
    plane = np.uint32(Y) * wpr
    n_slots = pool.shape[0]
    flat = pool.reshape(-1)
    block = np.full(entry.shape[0], -1, np.int64)
    base = np.zeros(entry.shape[0], np.uint32)
    pos, out, where = entry.copy(), [], []
    for _ in range(n_steps):
        pos = pos + step
        (i0x, fx), (i0y, fy), (i0z, fz) = (texel(pos[:, k], n) for k, n in enumerate(dims))
        x0 = np.clip(i0x, 0, X - 1)
        y0, y1 = np.clip(i0y, 0, Y - 1), np.clip(i0y + 1, 0, Y - 1)
        z0, z1 = np.clip(i0z, 0, Z - 1), np.clip(i0z + 1, 0, Z - 1)
        b = z0 >> 3
        new = b != block
        slot = np.clip(slab_map[b[new]], 0, n_slots - 1).astype(np.int64)
        block[new] = b[new]
        base[new] = ((16 * slot - 8 * b[new]) % 2**32).astype(np.uint32) * plane
        at = base + z0.astype(np.uint32) * plane + y0.astype(np.uint32) * wpr + \
            (x0 >> 1 if pair16 else x0).astype(np.uint32)
        dy = (y1 - y0).astype(np.uint32) * wpr
        dz = (z1 - z0).astype(np.uint32) * plane
        words = [flat[o] for o in (at, at + dy, at + dz, at + dz + dy)]
        if pair16:
            hi, lo = selectors(x0, i0x)
            c = [pool_tap(w.view(np.uint32), s) for w in words for s in (hi, lo)]
        else:
            c = [t for w in words for t in narrow_taps(w, i0x < 0)]
        c00 = c[0] + (c[1] - c[0]) * fx
        c10 = c[2] + (c[3] - c[2]) * fx
        c01 = c[4] + (c[5] - c[4]) * fx
        c11 = c[6] + (c[7] - c[6]) * fx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        out.append(c0 + (c1 - c0) * fz)
        where.append(pos)
    return np.stack(out), np.stack(where)


@pytest.mark.parametrize("direction", ["z_up", "z_down", "low_x"])
@pytest.mark.parametrize("fmt", ["pair16", "narrow"])
def test_pool_sampler_replay_equals_plain_sampler(fmt, direction):
    # (Z, Y, X) = (56, 6, 10): blocks 2-3 empty (slab 2 reads slot 0), blocks
    # 4-6 equal (slabs 4 and 5 share a slot)
    u8 = turbulence_volume((56, 6, 10), seed=5)
    u8[16:32] = 0
    u8[40:56] = np.tile(u8[32:40], (2, 1, 1))
    build = RK.build_slab_pool if fmt == "pair16" else RK.build_slab_pool_narrow
    pool, smap = build(torch.from_numpy(u8))
    slots = smap[0].tolist()
    assert slots[2] == 0 < slots[1] and slots[4] == slots[5] > 0
    dims = (10, 6, 56)
    rng = np.random.default_rng({"z_up": 1, "z_down": 2, "low_x": 3}[direction])
    n = 512
    entry = rng.uniform(0.0, 1.0, (n, 3)).astype(F32)
    step = (rng.uniform(-1.0, 1.0, (n, 3)) * 0.02).astype(F32)
    if direction == "low_x":  # along the x = 0 face, both sides of the first texel center
        entry[:, 0] = rng.uniform(-0.02, 0.12, n).astype(F32)
        step[:, 0] = (rng.uniform(-1.0, 1.0, n) * 0.002).astype(F32)
    else:  # through every z-block, one way
        entry[:, 2] = F32(-0.05) if direction == "z_up" else F32(1.05)
        step[:, 2] = F32(1.0 / 56) * (F32(1.0) if direction == "z_up" else F32(-1.0))
    got, pos = replay_march(pool.numpy(), smap[0].numpy(), dims, entry, step, 64)
    want = sample_trilinear_slab_pool(pool, smap, dims, torch.from_numpy(pos)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    i0x = texel(pos[..., 0], 10)[0]
    assert (np.clip(i0x, 0, 9) % 2 == 0).any() and (np.clip(i0x, 0, 9) % 2 == 1).any()
    if direction == "low_x":
        assert (i0x < 0).sum() > 1000
    else:
        blocks = np.clip(texel(pos[..., 2], 56)[0], 0, 55) >> 3
        assert set(np.unique(blocks)) == set(range(7))


@pytest.mark.parametrize("fmt", ["pair16", "narrow"])
def test_pool_sampler_replay_clamps_out_of_range_slots(fmt):
    u8 = turbulence_volume((32, 6, 10), seed=6)
    build = RK.build_slab_pool if fmt == "pair16" else RK.build_slab_pool_narrow
    pool, smap = build(torch.from_numpy(u8))
    bad = smap[0].numpy().copy()
    bad[0], bad[2], bad[3] = -7, pool.shape[0], 2**31 - 1
    clamped = torch.from_numpy(np.clip(bad, 0, pool.shape[0] - 1)[None])
    rng = np.random.default_rng(9)
    entry = rng.uniform(0.0, 1.0, (256, 3)).astype(F32)
    entry[:, 2] = F32(-0.05)
    step = (rng.uniform(-1.0, 1.0, (256, 3)) * 0.02).astype(F32)
    step[:, 2] = F32(1.0 / 32)
    got, pos = replay_march(pool.numpy(), bad, (10, 6, 32), entry, step, 40)
    want = sample_trilinear_slab_pool(pool, clamped, (10, 6, 32), torch.from_numpy(pos)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
