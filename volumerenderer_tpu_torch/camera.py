"""Camera model and per-pixel ray generation (PyTorch).

Counterpart of ``volumerenderer_tpu/camera.py``: a pinhole camera (GLM
``lookAt`` + ``perspectiveFov`` conventions) generates a world ray per pixel,
and a slab test against the unit cube [-0.5, 0.5]^3 yields each ray's entry
point in texture space.  Pixels whose rays miss the cube are masked.

The float32 arithmetic follows the JAX function operation for operation, so
the two agree to a few ulps (norms and cross products are written out, as
``jnp.linalg.norm`` and ``jnp.cross`` compute them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Camera", "look_at_basis", "generate_rays", "RayBundle"]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera in the volume's object space (unit cube at the origin)."""

    position: tuple[float, float, float] = (0.0, 0.0, -0.75)
    front: tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_degrees: float = 50.0
    width: int = 1600
    height: int = 1200

    @property
    def aspect(self) -> float:
        return self.width / self.height


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, keeping it: sqrt(sum(v*v))."""
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def look_at_basis(position, front, up):
    """Orthonormal camera basis following GLM ``lookAt``:
    f = normalize(front), s = normalize(cross(f, up)), u = cross(s, f).
    ``position`` is unused, as in GLM's rotation part."""
    f = front / _norm(front)
    s = _cross(f, up)
    s = s / _norm(s)
    u = _cross(s, f)
    return s, u, f


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """Per-pixel rays in object space.

    Attributes:
      entry_uv: (H, W, 3) float32 cube entry point in texture space [0,1]^3.
      direction: (H, W, 3) float32 normalized march direction.
      hit: (H, W) bool, True where the ray intersects the unit cube.
    """

    entry_uv: torch.Tensor
    direction: torch.Tensor
    hit: torch.Tensor


def generate_rays(camera: Camera, width: int | None = None, height: int | None = None,
                  device: torch.device | str = "cuda") -> RayBundle:
    """Generate the per-pixel ray bundle for ``camera`` on ``device``
    (optionally overriding the image size)."""
    w = int(width or camera.width)
    h = int(height or camera.height)
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.tensor(camera.position, **f32)
    front = torch.tensor(camera.front, **f32)
    up = torch.tensor(camera.up, **f32)
    tan_half_fov = float(np.float32(np.tan(np.radians(camera.fov_y_degrees) * 0.5)))
    s, u, f = look_at_basis(position, front, up)

    # Pixel centers -> NDC.  Row 0 = top of the image (flip vs GL's bottom origin).
    px = (torch.arange(w, **f32) + 0.5) / w * 2.0 - 1.0
    py = 1.0 - (torch.arange(h, **f32) + 0.5) / h * 2.0
    ndc_x, ndc_y = torch.meshgrid(px, py, indexing="xy")  # (H, W)

    # glm::perspectiveFov: x scales by tan(fov/2)*W/H and y by tan(fov/2);
    # the world direction of view-space (dx, dy, -1) is s*dx + u*dy + f.
    aspect = w / h
    dx = ndc_x * tan_half_fov * aspect
    dy = ndc_y * tan_half_fov
    d = dx[..., None] * s + dy[..., None] * u + f
    d = d / _norm(d)

    # Slab test against the unit cube [-0.5, 0.5]^3.
    eye = position.expand(d.shape)
    inv_d = torch.where(d.abs() > 1e-12, 1.0 / d,
                        torch.sign(d) * 1e12 + (d == 0).to(torch.float32) * 1e12)
    t0 = (-0.5 - eye) * inv_d
    t1 = (0.5 - eye) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = t_far > torch.clamp(t_near, min=0.0)
    t_entry = torch.clamp(t_near, min=0.0)

    entry = eye + t_entry[..., None] * d
    entry_uv = entry + 0.5  # vUV = object position + 0.5

    # Shader-faithful direction: normalize((vUV - 0.5) - camPos).
    geom_dir = entry_uv - 0.5 - position
    geom_dir = geom_dir / _norm(geom_dir)
    return RayBundle(entry_uv=entry_uv.contiguous(), direction=geom_dir.contiguous(),
                     hit=hit.contiguous())
