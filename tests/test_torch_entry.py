"""The port's flagship forward step (``entry.entry``) against the JAX
package's ``__graft_entry__.entry`` fallback branch: the plain compositing
render of the normalized sphere from the default camera, here at 64^2 on a
32^3 sphere.  On the same inputs (JAX's rays) within the compositing bar
(6e-7); from the port's own rays (within 1e-6 of JAX's, as
``test_torch_camera.py`` holds them) within the plain march's bar against
JAX (1e-5, ``test_torch_raycast.py``).  And the card as the default."""
import inspect

import numpy as np
import pytest
import torch

from volumerenderer_tpu import Camera as JCamera
from volumerenderer_tpu import as_normalized_volume as j_normalized
from volumerenderer_tpu import generate_rays as j_rays
from volumerenderer_tpu.io.synthetic import sphere_volume as j_sphere
from volumerenderer_tpu.ops.raycast import render_compositing as j_render

from volumerenderer_tpu_torch import entry as TE

COMP_BAR, RAYS_BAR, PLAIN_BAR = 6e-7, 1e-6, 1e-5
SHAPES = [((64, 64), (32, 32, 32)), ((48, 32), (16, 24, 32))]


def _jax_side(size, dims):
    rays = j_rays(JCamera(width=size[0], height=size[1]))
    want, _ = j_render(j_normalized(j_sphere(dims)), rays.entry_uv, rays.direction, rays.hit)
    return rays, np.asarray(want)


@pytest.mark.parametrize("size,dims", SHAPES)
def test_entry_cpu_matches_jax_fallback(size, dims):
    fn, args = TE._entry(size, dims, "cpu")
    rays, want = _jax_side(size, dims)
    same = tuple(torch.from_numpy(np.array(a)) for a in (rays.entry_uv, rays.direction, rays.hit))
    rgb = fn(args[0], *same)
    assert rgb.device.type == "cpu" and tuple(rgb.shape) == (size[1], size[0], 3)
    np.testing.assert_allclose(rgb.numpy(), want, rtol=0, atol=COMP_BAR)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(j_normalized(j_sphere(dims))))


@pytest.mark.parametrize("size,dims", SHAPES)
def test_entry_cpu_own_rays_match_jax(size, dims):
    fn, args = TE._entry(size, dims, "cpu")
    rays, want = _jax_side(size, dims)
    for got, ref in zip(args[1:3], (rays.entry_uv, rays.direction)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=RAYS_BAR)
    np.testing.assert_array_equal(args[3].numpy(), np.asarray(rays.hit))
    np.testing.assert_allclose(fn(*args).numpy(), want, rtol=0, atol=PLAIN_BAR)


def test_entry_keeps_the_jax_defaults(monkeypatch):
    """``entry()`` is the 1024^2 render of the 256^3 sphere; it takes a
    device and no size."""
    seen = {}
    monkeypatch.setattr(TE, "_entry", lambda size, dims, device: seen.update(
        size=size, dims=dims, device=device) or ("fn", ()))
    assert TE.entry(device="cpu") == ("fn", ())
    assert seen == {"size": (1024, 1024), "dims": (256, 256, 256), "device": "cpu"}
    assert list(inspect.signature(TE.entry).parameters) == ["device"]
    assert inspect.signature(TE.entry).parameters["device"].default == "cuda"


def test_entry_defaults_to_the_card():
    """Without a card and without ``device="cpu"`` it raises torch's own "no
    CUDA" error; with one, the example arguments lie on the card."""
    if torch.cuda.is_available():
        fn, args = TE._entry((16, 16), (8, 8, 8), "cuda")
        assert all(a.is_cuda for a in args)
        return
    with pytest.raises(AssertionError, match="CUDA"):
        TE._entry((16, 16), (8, 8, 8), "cuda")
