"""The port's differentiable level-cut decode (``codecs/diff.py``) against the
JAX package's custom VJP (``volumerenderer_tpu/codecs/diff.py``).

At tests/test_decode_vjp.py's sizes: a 16^3 sphere tree (tolerance 2, two
epochs), built by the JAX package and carried over with
``interop.kdtree_from_numpy``, so both decoders read the same codes.  The
forward at the tree's own distance map equals ``level_cut_device / 255`` bit
for bit; the gradients of ``dm`` and ``leaf_adjust`` equal JAX's custom VJP
on the same seeded inputs and cotangent (rtol 1e-5); through a 32^2 render
(``render_tf``, 24 steps) they equal JAX's within the TF gradient bar of
``docs/PARITY.md`` (rtol 2e-3).  JAX's jitted decode compiles anew per cut
depth, so the JAX comparisons take two depths.
"""
import dataclasses

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch import Camera, TFParams, generate_rays
from volumerenderer_tpu_torch.codecs import device as TD
from volumerenderer_tpu_torch.codecs.diff import DiffDecoder
from volumerenderer_tpu_torch.diff.transfer import render_tf
from volumerenderer_tpu_torch.interop import kdtree_from_numpy, rays_from_numpy
from volumerenderer_tpu_torch.io.synthetic import sphere_volume
from volumerenderer_tpu_torch.models import CompressedRenderer
from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import CompositingPlan, quantize_u8
from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import make_render_tf_voxel

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def trees():
    from volumerenderer_tpu.codecs import kdtree as JK

    vol = np.round(sphere_volume(SHAPE, radius=0.35, soft=0.25) * 255).astype(np.uint8)
    tj = JK.build(vol, tolerance=2, max_epochs=2)
    return tj, kdtree_from_numpy(**dataclasses.asdict(tj))


def _cut(tree, which):
    return {"full": tree.max_depth, "shallow": tree.orig_depth - 3}[which]


@pytest.mark.parametrize("which", ["full", "shallow"])
def test_forward_at_dm0_equals_device_decode(trees, which):
    _, tt = trees
    dt, spec = TD.to_device(tt, "cpu")
    cut = _cut(tt, which)
    dec = DiffDecoder(dt, spec, cut_depth=cut)
    ref = TD.level_cut_device(dt, spec, cut).to(torch.float32) / 255.0
    out = dec(dec.dm0)
    assert out.dtype == torch.float32 and torch.equal(out, ref)


def test_decoder_of_a_host_tree_and_of_the_renderer(trees):
    _, tt = trees
    dec = DiffDecoder(tt, device="cpu")
    via = CompressedRenderer(tt, "cpu").diff_decoder()
    assert dec.cut_depth == via.cut_depth == tt.max_depth
    assert torch.equal(dec(dec.dm0), via(via.dm0))
    # bytes / 255 against the renderer's bytes * (1/255): the same 8-bit grid
    assert torch.equal(quantize_u8(dec(dec.dm0)),
                       quantize_u8(CompressedRenderer(tt, "cpu").volume_at()))


def _inputs(dec, seed):
    rng = np.random.default_rng(seed)
    dm = np.asarray(dec.dm0, np.float32) + np.float32(0.37)
    adj = rng.uniform(-1.5, 1.5, dec.num_leaves).astype(np.float32)
    cot = rng.standard_normal(tuple(reversed(dec.spec["dims"]))).astype(np.float32)
    return dm, adj, cot


@pytest.mark.parametrize("which", ["full", "shallow"])
def test_gradients_equal_jax_custom_vjp(trees, which):
    import jax
    import jax.numpy as jnp
    from volumerenderer_tpu.codecs.diff import DiffDecoder as JDiffDecoder

    tj, tt = trees
    cut = _cut(tt, which)
    dec_t = DiffDecoder(tt, cut_depth=cut, device="cpu")
    dec_j = JDiffDecoder(tj, cut_depth=cut)
    dm, adj, cot = _inputs(dec_t, 5)
    out_j, vjp = jax.vjp(dec_j, jnp.asarray(dm), jnp.asarray(adj))
    g_dm_j, g_adj_j = vjp(jnp.asarray(cot))

    dm_t = torch.from_numpy(dm).requires_grad_(True)
    adj_t = torch.from_numpy(adj).requires_grad_(True)
    out_t = dec_t(dm_t, adj_t)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    assert float(np.abs(np.asarray(g_dm_j)).sum()) > 0
    np.testing.assert_allclose(dm_t.grad.numpy(), np.asarray(g_dm_j), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(g_dm_j)).max()))
    np.testing.assert_allclose(adj_t.grad.numpy(), np.asarray(g_adj_j), rtol=1e-5, atol=0)


def test_gradient_through_render_tf_equals_jax(trees):
    """d(loss)/d(dm, leaf_adjust) of an MSE pixel loss through the decode and
    the differentiable march, port against JAX (tests/test_decode_vjp.py's
    ``test_grad_through_render``)."""
    import jax
    import jax.numpy as jnp
    import volumerenderer_tpu as J
    from volumerenderer_tpu.codecs.diff import DiffDecoder as JDiffDecoder
    from volumerenderer_tpu.diff.transfer import TFParams as JTFParams
    from volumerenderer_tpu.diff.transfer import render_tf as j_render_tf

    tj, tt = trees
    rays_j = J.generate_rays(J.Camera(width=32, height=32))
    dec_j = JDiffDecoder(tj)
    target = np.zeros((32, 32, 3), np.float32)

    def loss_j(dm, adj):
        rgb, _ = j_render_tf(JTFParams.reference(), dec_j(dm, adj), rays_j.entry_uv,
                             rays_j.direction, rays_j.hit, max_samples=24)
        return jnp.mean((rgb - target) ** 2)

    dec = DiffDecoder(tt, device="cpu")
    dm = np.asarray(dec.dm0, np.float32) + np.float32(0.37)
    adj = np.full(dec.num_leaves, 0.5, np.float32)
    g_dm_j, g_adj_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(dm), jnp.asarray(adj))

    rays = rays_from_numpy(rays_j.entry_uv, rays_j.direction, rays_j.hit, device="cpu")
    dm_t = torch.from_numpy(dm).requires_grad_(True)
    adj_t = torch.from_numpy(adj).requires_grad_(True)
    rgb, _ = render_tf(TFParams.reference("cpu"), dec(dm_t, adj_t), rays.entry_uv,
                       rays.direction, rays.hit, max_samples=24)
    torch.mean((rgb - torch.from_numpy(target)) ** 2).backward()
    for g_t, g_j in ((dm_t.grad, g_dm_j), (adj_t.grad, g_adj_j)):
        g_j = np.asarray(g_j)
        assert np.isfinite(g_t.numpy()).all() and float(np.abs(g_j).sum()) > 0
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=2e-3, atol=2e-3 * np.abs(g_j).max())


def test_finetune_step_through_the_kernel_path(trees):
    """The compressed-domain fine-tune step as the card runs it: decode ->
    ``make_render_tf_voxel`` (B4 forward, B5 backward; their plain versions
    on the CPU) -> MSE -> backward.  Its gradients are finite and nonzero,
    and a step along them lowers the loss."""
    _, tt = trees
    dec = CompressedRenderer(tt, "cpu").diff_decoder()
    rays = generate_rays(Camera(width=32, height=32), device="cpu")
    plan = CompositingPlan(rays.entry_uv, rays.direction, rays.hit, SHAPE, max_samples=24)
    f = make_render_tf_voxel(plan)
    params = TFParams.reference("cpu")
    target = torch.full((32, 32, 3), 0.9)

    def loss(dm, adj):
        rgb, _ = f(params, dec(dm, adj))
        return torch.mean((rgb - target) ** 2)

    dm = dec.dm0.clone().requires_grad_(True)
    adj = dec.zero_leaf_adjust().requires_grad_(True)
    value = loss(dm, adj)
    g_dm, g_adj = torch.autograd.grad(value, (dm, adj))
    value = value.detach()
    assert torch.isfinite(g_dm).all() and torch.isfinite(g_adj).all()
    assert float(g_adj.abs().sum()) > 0
    with torch.no_grad():
        lower = loss(dm, adj - 20.0 * g_adj / g_adj.abs().max())
    assert float(lower) < float(value)
