"""The benchmark's plain reference: rays, the compositing march, the isosurface
march and shade, and the differentiable TF render, in plain PyTorch.

A frozen copy of the arithmetic the upstream shaders define (raycaster.frag,
isosurface.frag) as the port's plain functions write it, so that later
changes to the program cannot move what it is held against.  It imports
nothing of the program: every function works from a camera, a volume and
parameters that the benchmark made itself.

* rays: a pinhole camera (GLM lookAt + perspectiveFov), the slab test
  against the unit cube, entry points in texture space;
* sampling: trilinear taps of the 8-bit grid (clamp to edge), each tap
  ``byte * (1/255)``, the lerps along x, y, z, each product and sum its own
  operation;
* compositing: ``pos += dir_step`` before each sample, up to 300 steps, the
  open-interval exit, ``pa = s - s*a; c += pa*s; a += pa*0.6``, the
  early-out at a > 0.99, then ``r = g = 1 - c, b = 1``;
* isosurface: the first upward crossing between a sample and its lookahead,
  4 bisections, the central-difference normal (DELTA 0.01), headlight Phong;
* the TF render: the compositing march with learnable scalars, through
  plain autograd, the volume quantized to 8 bits on the way in with its
  gradient passed straight through (the gradient of every tap value read,
  added at its voxel).

``dtype`` selects the precision of every value computed from a sample (the
taps, lerps, accumulators and shading); positions stay float32.  float32 is
the reference; bfloat16 is the control, which a correct comparison has to
refuse.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MAX_SAMPLES = 300
ALPHA_SCALE = 0.6
EARLY_OUT_ALPHA = 0.99
DELTA = 0.01
SPEC_POWER = 250.0
DIFFUSE = (0.39, 0.58, 0.93)
BLOCK = 8


@dataclasses.dataclass(frozen=True)
class Camera:
    position: tuple = (0.0, 0.0, -0.75)
    front: tuple = (0.0, 0.0, 1.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_y_degrees: float = 50.0
    width: int = 1600
    height: int = 1200


@dataclasses.dataclass(frozen=True)
class Rays:
    entry_uv: torch.Tensor   # (H, W, 3) float32
    direction: torch.Tensor  # (H, W, 3) float32
    hit: torch.Tensor        # (H, W) bool


def _norm_keep(v):
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def generate_rays(cam: Camera, device) -> Rays:
    """Per-pixel rays of ``cam``: row 0 at the top, the slab test against
    [-0.5, 0.5]^3, ``entry_uv = entry + 0.5``, the direction
    ``normalize((entry_uv - 0.5) - position)``."""
    w, h = int(cam.width), int(cam.height)
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.tensor(cam.position, **f32)
    front = torch.tensor(cam.front, **f32)
    up = torch.tensor(cam.up, **f32)
    tan_half_fov = float(np.float32(np.tan(np.radians(cam.fov_y_degrees) * 0.5)))
    f = front / _norm_keep(front)
    s = _cross(f, up)
    s = s / _norm_keep(s)
    u = _cross(s, f)
    px = (torch.arange(w, **f32) + 0.5) / w * 2.0 - 1.0
    py = 1.0 - (torch.arange(h, **f32) + 0.5) / h * 2.0
    ndc_x, ndc_y = torch.meshgrid(px, py, indexing="xy")
    aspect = w / h
    dx = ndc_x * tan_half_fov * aspect
    dy = ndc_y * tan_half_fov
    d = dx[..., None] * s + dy[..., None] * u + f
    d = d / _norm_keep(d)
    eye = position.expand(d.shape)
    inv_d = torch.where(d.abs() > 1e-12, 1.0 / d,
                        torch.sign(d) * 1e12 + (d == 0).to(torch.float32) * 1e12)
    t0 = (-0.5 - eye) * inv_d
    t1 = (0.5 - eye) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = t_far > torch.clamp(t_near, min=0.0)
    entry_uv = eye + torch.clamp(t_near, min=0.0)[..., None] * d + 0.5
    geom = entry_uv - 0.5 - position
    geom = geom / _norm_keep(geom)
    return Rays(entry_uv.contiguous(), geom.contiguous(), hit.contiguous())


def step_sizes(dims, device) -> torch.Tensor:
    X, Y, Z = dims
    return torch.tensor([1.0 / X, 1.0 / Y, 1.0 / Z], dtype=torch.float32, device=device)


def quantize(volume: torch.Tensor) -> torch.Tensor:
    """The 8-bit grid the renderer samples: a uint8 volume as it is, a
    float32 volume in [0, 1] as ``round(clamp(v, 0, 1) * 255)``."""
    if volume.dtype == torch.uint8:
        return volume
    return torch.round(torch.clamp(volume, 0.0, 1.0) * 255.0).to(torch.uint8)


class Sampler:
    """Trilinear taps of a (Z, Y, X) volume, clamp to edge, at positions
    (..., 3) with x first.  ``volume`` is uint8 (each tap ``byte * (1/255)``)
    or a float32 tensor whose values are sampled as they are (the
    differentiable path).  With ``record`` (a flat bool tensor of the
    volume's voxels) every tap index read is set in it; with ``leaves`` (a
    list) every tap value is made an autograd leaf and appended to it with
    its flat indices."""

    def __init__(self, volume: torch.Tensor, dtype=torch.float32, record=None, leaves=None):
        self.flat = volume.reshape(-1)
        self.leaves = leaves
        Z, Y, X = volume.shape
        self.dims = (X, Y, Z)
        self.dtype = dtype
        self.record = record
        self.fdims = torch.tensor([float(X), float(Y), float(Z)], dtype=torch.float32,
                                  device=volume.device)

    def taps(self, uvw: torch.Tensor):
        """The 8 flat tap indices (c000, c100, ..., c111) and the fractions."""
        X, Y, Z = self.dims
        t = uvw * self.fdims - 0.5
        i0f = torch.floor(t)
        i0 = i0f.to(torch.int64)

        def axis(i, n, stride):
            return (torch.clamp(i, 0, n - 1) * stride, torch.clamp(i + 1, 0, n - 1) * stride)

        xs = axis(i0[..., 0], X, 1)
        ys = axis(i0[..., 1], Y, X)
        zs = axis(i0[..., 2], Z, X * Y)
        return [z + y + x for z in zs for y in ys for x in xs], t - i0f

    def mark(self, uvw: torch.Tensor) -> None:
        """Set the voxels the taps at ``uvw`` read in ``record``."""
        for i in self.taps(uvw)[0]:
            self.record[i.reshape(-1)] = True

    def __call__(self, uvw: torch.Tensor) -> torch.Tensor:
        idx, frac = self.taps(uvw)
        frac = frac.to(self.dtype)
        if self.record is not None:
            for i in idx:
                self.record[i.reshape(-1)] = True
        if self.flat.dtype == torch.uint8:
            vals = [self.flat[i].to(torch.float32) * (1.0 / 255.0) for i in idx]
        else:
            vals = [self.flat[i] for i in idx]
        if self.leaves is not None:
            vals = [v.requires_grad_(True) for v in vals]
            self.leaves.extend(zip(idx, vals))
        vals = [v.to(self.dtype) for v in vals]
        c000, c100, c010, c110, c001, c101, c011, c111 = vals
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        c00 = c000 + (c100 - c000) * fx
        c10 = c010 + (c110 - c010) * fx
        c01 = c001 + (c101 - c001) * fx
        c11 = c011 + (c111 - c011) * fx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        return c0 + (c1 - c0) * fz


def _inside(pos):
    return ((pos > 0.0) & (pos < 1.0)).all(dim=-1)


def composite(vol_u8: torch.Tensor, rays: Rays, max_samples: int = MAX_SAMPLES,
              dtype=torch.float32, record=None, alpha_scale: float = ALPHA_SCALE):
    """The compositing march and the fixed transfer.  Returns (rgb (H, W, 3),
    alpha (H, W), samples (H, W): the steps each ray took while alive).
    With ``record`` the voxels the taken samples' taps read are set in it;
    ``alpha_scale`` other than 0.6 counts the steps of a TF march."""
    Z, Y, X = vol_u8.shape
    sample = Sampler(vol_u8, dtype, record)
    dir_step = rays.direction * step_sizes((X, Y, Z), rays.direction.device)
    shape = rays.hit.shape
    pos = rays.entry_uv
    color = torch.zeros(shape, dtype=dtype, device=pos.device)
    alpha = torch.zeros(shape, dtype=dtype, device=pos.device)
    n = torch.zeros(shape, dtype=torch.int32, device=pos.device)
    alive = rays.hit.to(torch.bool)
    for _ in range(max_samples):
        if not bool(alive.any()):
            break
        pos = pos + dir_step
        alive = alive & _inside(pos)
        s = sample(pos) if record is None else _sample_alive(sample, pos, alive, dtype)
        pa = s - s * alpha
        color = torch.where(alive, color + pa * s, color)
        alpha = torch.where(alive, alpha + pa * alpha_scale, alpha)
        n = n + alive.to(torch.int32)
        alive = alive & (alpha <= EARLY_OUT_ALPHA)
    inv = (1.0 - color).to(torch.float32)
    rgb = torch.stack([inv, inv, torch.ones_like(inv)], dim=-1)
    return rgb, alpha.to(torch.float32), n


def _sample_alive(sample, pos, alive, dtype):
    """Samples where ``alive`` (zero elsewhere), so that a recording sampler
    records only the taps of samples the march takes."""
    s = torch.zeros(alive.shape, dtype=dtype, device=pos.device)
    s[alive] = sample(pos[alive])
    return s


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(v):
    """Length over the last axis as the upstream's float32 path rounds it:
    ``v0*v0``, then the other two squares each added in one rounding."""
    if v.dtype != torch.float32:
        return torch.sqrt(_dot(v, v))
    v64 = v.to(torch.float64)
    acc = v[..., 0] * v[..., 0]
    acc = (v64[..., 1] * v64[..., 1] + acc.to(torch.float64)).to(torch.float32)
    acc = (v64[..., 2] * v64[..., 2] + acc.to(torch.float64)).to(torch.float32)
    return torch.sqrt(acc)


def block_grid(vol_u8: torch.Tensor) -> torch.Tensor:
    """Per 8^3 block of tap anchors the least and largest byte its taps can
    read, over the texels [8b, 8b + 8] of each axis clamped to the edge:
    (ceil(Z/8), ceil(Y/8), ceil(X/8), 2) uint8."""
    out = []
    for reduce, pair in ((torch.amin, torch.minimum), (torch.amax, torch.maximum)):
        r = vol_u8
        for axis in range(3):
            n = r.shape[axis]
            nb = -(-n // BLOCK)
            j = torch.arange(BLOCK * nb + 1, device=r.device)
            ext = r.index_select(axis, j.clamp(max=n - 1))
            body = ext.narrow(axis, 0, BLOCK * nb)
            blocks = reduce(body.reshape(body.shape[:axis] + (nb, BLOCK)
                                         + body.shape[axis + 1:]), dim=axis + 1)
            r = pair(blocks, ext.index_select(axis, j[BLOCK::BLOCK]))
        out.append(r)
    return torch.stack(out, dim=-1).contiguous()


def _mixed(grid, dims, uvw, iso):
    """Where the block of each position's lower tap anchor straddles iso
    (neither wholly below nor wholly at or above it): the samples a bound
    march gathers."""
    fdims = torch.tensor([float(d) for d in dims], dtype=torch.float32, device=uvw.device)
    i0 = torch.floor(uvw * fdims - 0.5).to(torch.int64)
    n = torch.tensor(dims, dtype=torch.int64, device=uvw.device)
    b = torch.clamp(i0, min=0).minimum(n - 1) // BLOCK
    cell = grid[b[..., 2], b[..., 1], b[..., 0]].to(torch.float32)
    iso255 = _f32(iso, uvw.device) * 255.0
    return ~(cell[..., 1] + 0.5 < iso255) & ~(cell[..., 0] - 0.5 >= iso255)


def iso_march(vol_u8: torch.Tensor, rays: Rays, iso: float, max_samples: int = MAX_SAMPLES,
              dtype=torch.float32, grid=None, record=None):
    """The first upward crossing of ``iso`` between the sample at ``pos``
    and the lookahead at ``pos + dir_step``.  Returns (found, near, counts):
    ``near`` the position at the crossing (entry for a miss); ``counts`` the
    per-ray steps taken while alive and, given the block ``grid``, the
    samples a bound march gathers (in mixed blocks), whose taps' voxels are
    set in ``record`` if given."""
    Z, Y, X = vol_u8.shape
    dims = (X, Y, Z)
    sample = Sampler(vol_u8, dtype)
    marker = Sampler(vol_u8, dtype, record) if record is not None else None

    def gather(uvw, alive):
        mixed = alive & _mixed(grid, dims, uvw, iso)
        if marker is not None:
            marker.mark(uvw[mixed])
        return mixed.to(torch.int32)

    dir_step = rays.direction * step_sizes(dims, rays.direction.device)
    iso_t = _f32(iso, rays.direction.device).to(dtype)
    shape = rays.hit.shape
    dev = rays.direction.device
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    n = torch.zeros(shape, dtype=torch.int32, device=dev)
    gathered = torch.zeros(shape, dtype=torch.int32, device=dev)
    alive = rays.hit.to(torch.bool)
    pos = near = rays.entry_uv
    was_below = None
    for _ in range(max_samples):
        if not bool(alive.any()):
            break
        pos = pos + dir_step
        alive = alive & _inside(pos)
        if was_below is None:
            was_below = (sample(pos) - iso_t) < 0.0
            if grid is not None:
                gathered = gathered + gather(pos, alive)
        look = pos + dir_step
        is_below = (sample(look) - iso_t) < 0.0
        if grid is not None:
            gathered = gathered + gather(look, alive)
        crossing = alive & was_below & ~is_below
        near = torch.where(crossing[..., None], pos, near)
        found = found | crossing
        n = n + alive.to(torch.int32)
        alive = alive & ~crossing
        was_below = is_below
    return found, near, {"steps": n, "gathered": gathered if grid is not None else None}


def iso_shade(vol_u8: torch.Tensor, rays: Rays, found, near, iso: float, dtype=torch.float32,
              record=None):
    """4 bisections in ``[near, near + dir_step]``, the central-difference
    normal, headlight Phong clipped to [0, 1]; rays without ``found`` are
    white.  Shades only the found rays.  Returns (H, W, 3) float32."""
    Z, Y, X = vol_u8.shape
    sample = Sampler(vol_u8, dtype, record)
    dev = rays.direction.device
    rgb = torch.ones(rays.hit.shape + (3,), dtype=torch.float32, device=dev)
    if not bool(found.any()):
        return rgb
    d = rays.direction[found]
    left = near[found]
    right = left + d * step_sizes((X, Y, Z), dev)
    iso_t = _f32(iso, dev).to(dtype)
    for _ in range(4):
        mid = (right + left) * 0.5
        go_left = (sample(mid) < iso_t)[..., None]
        left = torch.where(go_left, mid, left)
        right = torch.where(go_left, right, mid)
    tc = (right + left) * 0.5
    offsets = torch.eye(3, dtype=torch.float32, device=dev) * DELTA
    s1 = torch.stack([sample(tc - offsets[i]) for i in range(3)], dim=-1)
    s2 = torch.stack([sample(tc + offsets[i]) for i in range(3)], dim=-1)
    g = (s1 - s2) / 2.0
    norm = _norm(g)[..., None]
    N = g / torch.where(norm > 0, norm, torch.ones_like(norm))
    V = (-d).to(dtype)
    L = V
    diffuse = torch.clamp_min(_dot(L, N), 0.0)
    half = L + V
    half = half / _norm(half)[..., None]
    spec = torch.pow(torch.maximum(_f32(1e-5, dev).to(dtype), _dot(half, N)), SPEC_POWER)
    color = torch.tensor(DIFFUSE, dtype=dtype, device=dev)
    shaded = torch.clamp(diffuse[..., None] * color + spec[..., None], 0.0, 1.0)
    rgb[found] = shaded.to(torch.float32)
    return rgb


def iso_render(vol_u8, rays: Rays, iso: float, dtype=torch.float32):
    """March and shade: (rgb (H, W, 3), found (H, W))."""
    found, near, _ = iso_march(vol_u8, rays, iso, dtype=dtype)
    return iso_shade(vol_u8, rays, found, near, iso, dtype=dtype), found


def tf_render(params, q_u8: torch.Tensor, rays: Rays, max_samples: int = MAX_SAMPLES,
              dtype=torch.float32, taps=None):
    """The differentiable TF render: (rgb (H, W, 3), alpha).  ``params`` is
    (alpha_scale, color_gain, color_bias, flip_sign (3,), flip_bias (3,));
    ``q_u8`` the (Z, Y, X) 8-bit grid the volume is sampled on.  The march
    carries only the rays still alive, so that autograd keeps the steps
    taken and no others; the arithmetic of each step is the masked
    march's.  With ``taps`` (a list), each step's 8 tap values are autograd
    leaves, appended to it with their flat voxel indices: the volume's
    gradient, straight through the quantization, is their gradients added
    at those indices (:func:`volume_grad`)."""
    K, G, B, flip_sign, flip_bias = (p.to(dtype) for p in params)
    Z, Y, X = q_u8.shape
    sample = Sampler(q_u8, dtype, leaves=taps)
    dev = rays.direction.device
    n_rays = rays.hit.numel()
    idx = torch.nonzero(rays.hit.reshape(-1)).squeeze(1)
    pos = rays.entry_uv.reshape(-1, 3)[idx]
    dir_step = (rays.direction * step_sizes((X, Y, Z), dev)).reshape(-1, 3)[idx]
    color = torch.zeros(idx.shape, dtype=dtype, device=dev)
    alpha = torch.zeros(idx.shape, dtype=dtype, device=dev)
    done = []  # (ray indices, color, alpha) of the rays whose march ended

    def finish(stop):
        nonlocal idx, pos, dir_step, color, alpha
        done.append((idx[stop], color[stop], alpha[stop]))
        go = ~stop
        idx, pos, dir_step, color, alpha = idx[go], pos[go], dir_step[go], color[go], alpha[go]

    for _ in range(max_samples):
        if idx.numel() == 0:
            break
        pos = pos + dir_step
        outside = ~_inside(pos)
        if bool(outside.any()):
            finish(outside)
        s = sample(pos)
        sc = s * G + B
        pa = s - s * alpha
        color = color + pa * sc
        alpha = alpha + pa * K
        saturated = alpha > EARLY_OUT_ALPHA
        if bool(saturated.any()):
            finish(saturated)
    done.append((idx, color, alpha))
    ray = torch.cat([d[0] for d in done])
    full = lambda k: torch.zeros(n_rays, dtype=dtype, device=dev).index_put(
        (ray,), torch.cat([d[k] for d in done])).reshape(rays.hit.shape)
    color, alpha = full(1), full(2)
    rgb = flip_sign * color[..., None] + flip_bias
    return rgb.to(torch.float32), alpha.to(torch.float32)


def volume_grad(taps, grads, out: torch.Tensor) -> None:
    """Add the volume's gradient from :func:`tf_render`'s tap leaves and
    their gradients into ``out``: each at its voxel (the adjoint of the
    gather)."""
    flat = out.view(-1)
    for (i, _), g in zip(taps, grads):
        if g is not None:
            flat.index_add_(0, i.reshape(-1), g.reshape(-1).to(torch.float32))


CHUNK = 1 << 26  # elements: the norms and updates of a large volume go in slices


def norm(t: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    """The float64 2-norm of ``t`` (or of ``t - minus``, the difference
    taken in float32), a slice at a time."""
    a = t.reshape(-1)
    b = None if minus is None else minus.reshape(-1)
    total = 0.0
    for k in range(0, a.numel(), CHUNK):
        x = a[k:k + CHUNK] if b is None else a[k:k + CHUNK] - b[k:k + CHUNK]
        total += float(torch.sum(x.to(torch.float64) ** 2))
    return math.sqrt(total)


def sgd_(t: torch.Tensor, lr: float, g: torch.Tensor) -> None:
    """``t -= lr * g`` in place, a slice at a time."""
    a, b = t.view(-1), g.reshape(-1)
    for k in range(0, a.numel(), CHUNK):
        a[k:k + CHUNK].sub_(lr * b[k:k + CHUNK])


def fit_steps(params0, volume0, views, targets, lr: dict, n_steps: int, dtype=torch.float32):
    """``n_steps`` steps of the multi-view fit from (params0, volume0): each
    the mean squared error of every view's render against its target over
    all views' pixels, its gradients by plain autograd (to the TF scalars
    and to the volume's 8-bit grid, passed straight through to the float
    volume), and SGD with ``lr["params"]`` and ``lr["volume"]``.  Views
    are rendered one at a time and their gradients summed.  Returns
    (losses, the norm of each leaf's first gradient, params and volume
    after the last step)."""
    params = [p.detach().clone() for p in params0]
    volume = volume0.detach().clone()
    n_total = sum(int(t.numel()) for t in targets)
    losses, first = [], None
    for _ in range(n_steps):
        leaves = [p.clone().requires_grad_(True) for p in params]
        q = quantize(volume)
        loss = torch.zeros((), dtype=torch.float64, device=volume.device)
        grads = [torch.zeros_like(p) for p in params]
        g_vol = torch.zeros_like(volume)
        for rays, target in zip(views, targets):
            taps = []
            rgb, _ = tf_render(leaves, q, rays, dtype=dtype, taps=taps)
            part = torch.sum((rgb - target) ** 2) / n_total
            g = torch.autograd.grad(part, [*leaves, *(v for _, v in taps)], allow_unused=True)
            grads = [a + b for a, b in zip(grads, g[:len(leaves)])]
            volume_grad(taps, g[len(leaves):], g_vol)
            loss = loss + part.detach().to(torch.float64)
            del taps, g, rgb, part
        del q
        losses.append(float(loss))
        if first is None:
            first = [norm(g) for g in grads + [g_vol]]
        params = [p - lr["params"] * g for p, g in zip(params, grads)]
        sgd_(volume, lr["volume"], g_vol)
        del g_vol
    return losses, first, params, volume


def orbit_camera(az_deg: float, width: int, height: int, fov: float = 50.0,
                 radius: float = 0.75) -> Camera:
    """The orbit of the port's bench: the eye (0, 0, -radius) turned by
    ``az_deg`` about +y, looking at the center."""
    a = math.radians(az_deg)
    return Camera(position=(radius * math.sin(a), 0.0, -radius * math.cos(a)),
                  front=(-math.sin(a), 0.0, math.cos(a)), fov_y_degrees=fov,
                  width=width, height=height)
