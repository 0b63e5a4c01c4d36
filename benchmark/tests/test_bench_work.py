"""The work counts reproduce PERF.md section 6's bytes and operations of B1
and of the bound B2 at the bench's shapes (1024^2 rays, the 256^3
turbulence, the counts that section's table gives)."""
import pytest

from vrbench import harness

WORK = harness.work_modules()
RAYS = 1024 * 1024


def test_b1_at_the_bench_shapes():
    # 9.38 samples a ray, 37.5 K voxels read, float32 volume: 43.1 MB, 0.808 Gop
    n_bytes, ops = WORK["composite"].march(RAYS, 9.38 * RAYS, 37.5e3, 4)
    assert n_bytes / 1e6 == pytest.approx(43.1, abs=0.05)
    assert ops / 1e9 == pytest.approx(0.808, abs=0.0005)


def test_bound_b2_at_the_bench_shapes():
    # 180.62 samples and 31.62 gathered a ray, the whole 256^3 byte volume
    # counted, 0.708 M hits (near 8.5 MB): 56.8 MB, 4.579 Gop
    hits = 8.5e6 / 12
    n_bytes, ops = WORK["iso"].march(RAYS, hits, 180.62 * RAYS, 31.62 * RAYS, 256 ** 3,
                                     2 * 32 ** 3)
    assert n_bytes / 1e6 == pytest.approx(56.8, abs=0.05)
    assert ops / 1e9 == pytest.approx(4.579, abs=0.0005)


def test_shade_and_bind_count_what_they_move():
    n_bytes, ops = WORK["iso"].shade(RAYS, 1000.0, 5000.0)
    assert n_bytes == 5000 + 36 * 1000 + 13 * RAYS and ops == 515 * 1000
    assert WORK["iso"].bind(3.0e9, 1e6) == (3.0e9 + 1e6, 0.0)


def test_fit_step_bounds_its_kernels_operations():
    fwd = WORK["fit"].forward(RAYS, 10 * RAYS, 1e5)
    bwd = WORK["fit"].backward(RAYS, 10 * RAYS, 256 ** 3)
    step = WORK["fit"].step(RAYS, 10 * RAYS, 256 ** 3)
    assert step[1] == fwd[1] + bwd[1]
    assert step[0] >= 8 * 256 ** 3
