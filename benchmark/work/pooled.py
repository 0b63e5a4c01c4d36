"""Work of the pooled compositing march (B7): the bytes it has to move and the
float32 operations it has to do, from the shapes, the samples per ray and
the pool words the taps read, which the benchmark's plain reference counts
on the same inputs (``TapWords``).

Conventions (PERF.md, section 6): each input read once and each output
written once; of the pool only the int32 words the taps read.  A tap whose
lower corner is (x0, y, z) in the slab of z-block b = z0 // 8 reads word
x0 // 2 of rows z0 and z0 + 1 of that slab's slot (a pair16 word holds the
pairs of x = 2k and 2k + 1, each pair the bytes at x and x + 1), so a word
is (b, z - 8b, y, x0 // 2).  Per step 50 operations (a trilinear sample
41, a position step 3, compositing 6), one per ray for the transfer; the
slab map's 4 bytes a z-block are left out.
"""
import torch

RAY_BYTES = 25       # entry_uv and dir_step (float32 x 3 each), hit (1 byte)
RGBA_BYTES = 16      # rgb (float32 x 3) and alpha written
WORD_BYTES = 4
OPS_PER_STEP = 50
TRANSFER_OPS_PER_RAY = 1
SLAB_H = 16


def march(rays: float, samples: float, words_read: float):
    """(bytes, ops) of one launch over ``rays`` rays taking ``samples``
    samples in all, whose taps read ``words_read`` distinct pool words."""
    return (WORD_BYTES * words_read + (RAY_BYTES + RGBA_BYTES) * rays,
            OPS_PER_STEP * samples + TRANSFER_OPS_PER_RAY * rays)


class TapWords:
    """A ``record`` for the reference's sampler (``reference.Sampler``),
    which sets each of a sample's 8 tap indices in turn (c000, c100, c010,
    c110, c001, c101, c011, c111: z outer, x inner): of the x0 taps it
    marks the pool word each reads."""

    def __init__(self, shape):
        Z, Y, X = shape
        self.Y, self.X, self.W = Y, X, X // 2
        self.seen = torch.zeros((Z + 7) // 8 * SLAB_H * Y * self.W, dtype=torch.bool)
        self.calls = 0
        self.block = None

    def __setitem__(self, idx, value):
        k = self.calls % 8
        self.calls += 1
        if k % 2:
            return  # the x1 taps: read from the x0 tap's word
        if self.seen.device != idx.device:
            self.seen = self.seen.to(idx.device)
        z, rest = idx // (self.Y * self.X), idx % (self.Y * self.X)
        y, x = rest // self.X, rest % self.X
        if k == 0:
            self.block = z // 8  # the slab the sample's taps read
        row = z - 8 * self.block
        self.seen[((self.block * SLAB_H + row) * self.Y + y) * self.W + x // 2] = True

    def count(self) -> float:
        return float(self.seen.sum())
