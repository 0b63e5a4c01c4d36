"""Differentiable level-cut decode: the compressed tree's decode with a
hand-written adjoint, for compressed-domain fine-tuning.

Counterpart of ``volumerenderer_tpu/codecs/diff.py`` (its ``jax.custom_vjp``
becomes a ``torch.autograd.Function``).  The decode is a per-depth
clamped-Δ accumulation along each leaf's root path (``codecs/device.py``).
Its adjoint is cheap and structured:

* with respect to the per-depth Δ map ``dm``: at depth d every node that is
  not frozen, whose code is +Δ or −Δ and whose clamp is inactive, adds ±1:
  the cotangent is a masked sum over the level;
* with respect to the per-leaf adjustment ``leaf_adjust`` (added inside a
  final [0, 255] clamp): the identity inside the clamp;
* through the binary expansion of each level (``repeat_interleave(2)``):
  the pairwise sum toward the parent level.

The forward saves only the scalars entering each applied level (about two
per leaf) and the pre-clamp leaf values; the backward rebuilds the code and
frozen masks from the packed 2-bit streams, as the JAX custom VJP does.  No
``pallas_call`` is involved: plain torch operations on the tree's device.

The forward equals ``level_cut_device(...) / 255`` bit for bit when ``dm``
holds the tree's integer distance map and ``leaf_adjust`` is zero: every
value it adds is an integral float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.bitarray import unpack2
from .device import DeviceKdTree, _spec_key, to_device
from .kdtree import _leaf_axes_perm

__all__ = ["DiffDecoder", "decode_leaf_scalars_diff"]


def _level_step_fwd(s, frozen, codes, dmd):
    """One depth of the clamped-Δ accumulation in float32 (``device._step``
    with a float Δ): (scalars, frozen) after the level."""
    add = (codes == 1) & ~frozen
    sub = (codes == 2) & ~frozen
    s_new = torch.where(add, torch.clamp(s + dmd, max=255.0),
                        torch.where(sub, torch.clamp(s - dmd, min=0.0), s))
    return s_new, frozen | (codes == 3)


def _level_step_bwd(s, frozen, codes, dmd, g):
    """The adjoint of one depth: (g for the scalars entering it, g for its
    Δ).  The clamp's derivative takes the open-interval subgradient: 0 at
    the bound itself."""
    add = (codes == 1) & ~frozen
    sub = (codes == 2) & ~frozen
    act_add = add & (s + dmd < 255.0)
    act_sub = sub & (s - dmd > 0.0)
    passthrough = torch.where(add, act_add, torch.where(sub, act_sub, True))
    zero = torch.zeros_like(g)
    ds = torch.where(passthrough, g, zero)
    d_dmd = torch.sum(torch.where(act_add, g, zero) - torch.where(act_sub, g, zero))
    return ds, d_dmd


def _unpacked_codes(packed_levels, packed_chains, spec_key, cut_depth):
    """(each level's codes up to the cut, the chain code columns or None),
    uint8, unpacked from the packed streams on their device."""
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    levels = [unpack2(packed_levels[d])[:1 << d] for d in range(min(orig_depth, cut_depth) + 1)]
    chains = unpack2(packed_chains) if cut_depth > orig_depth else None
    return levels, chains


def _applied_levels(spec_key, cut_depth, levels, chains):
    """The codes of every depth the decode applies a step at, in order
    (depths past the cut expand without one), each with its depth."""
    dims, orig_depth, max_depth, schedule, chain_len = spec_key
    out = [(d, levels[d]) for d in range(1, min(orig_depth, cut_depth) + 1)]
    if cut_depth > orig_depth:
        out += [(orig_depth + 1 + i, chains[:, i])
                for i in range(min(chain_len, cut_depth - orig_depth))]
    return out


def _expansions(spec_key, cut_depth):
    """For each applied step, how many repeat(2) expansions come before it
    since the last one, and how many trail after the last step."""
    orig_depth = spec_key[1]
    reps, n = [], 0
    for d in range(1, orig_depth + 1):
        n += 1
        if d <= cut_depth:
            reps.append(n)
            n = 0
    if cut_depth > orig_depth:
        reps += [0] * min(spec_key[4], cut_depth - orig_depth)
    return reps, n


def _decode_fwd_res(spec_key, cut_depth, dm, leaf_adjust, packed_levels, packed_chains):
    """The forward: (leaf scalars clamped to [0, 255], the scalars entering
    each applied step, the pre-clamp leaf values)."""
    levels, chains = _unpacked_codes(packed_levels, packed_chains, spec_key, cut_depth)
    reps, trailing = _expansions(spec_key, cut_depth)
    saved = []
    s = dm[:1].to(torch.float32)
    frozen = levels[0] == 3
    for (d, codes), n in zip(_applied_levels(spec_key, cut_depth, levels, chains), reps):
        s = s.repeat_interleave(1 << n) if n else s
        frozen = frozen.repeat_interleave(1 << n) if n else frozen
        saved.append(s)
        s, frozen = _level_step_fwd(s, frozen, codes, dm[d])
    if trailing:
        s = s.repeat_interleave(1 << trailing)
    pre_clip = s + leaf_adjust
    return torch.clamp(pre_clip, 0.0, 255.0), saved, pre_clip


def _decode_bwd(spec_key, cut_depth, saved, pre_clip, dm, packed_levels, packed_chains, g):
    """The backward: (g for ``dm``, g for ``leaf_adjust``)."""
    levels, chains = _unpacked_codes(packed_levels, packed_chains, spec_key, cut_depth)
    steps = _applied_levels(spec_key, cut_depth, levels, chains)
    reps, trailing = _expansions(spec_key, cut_depth)
    # the strict subgradient of the final clamp: clamped leaves get zero
    # (exactly-zero background stays zero, so occupancy skips stay valid
    # under fine-tuning)
    inside = (pre_clip > 0.0) & (pre_clip < 255.0)
    g = torch.where(inside, g, torch.zeros_like(g))
    d_leaf_adjust = g
    d_dm = [torch.zeros((), dtype=torch.float32, device=g.device)] * dm.shape[0]
    # the frozen mask entering each applied step, rebuilt forward (bools)
    frozen_at = []
    frozen = levels[0] == 3
    for (d, codes), n in zip(steps, reps):
        frozen = frozen.repeat_interleave(1 << n) if n else frozen
        frozen_at.append(frozen)
        frozen = frozen | (codes == 3)
    # the transpose of each repeat(2) expansion sums child pairs to the parent
    for _ in range(trailing):
        g = g.reshape(-1, 2).sum(dim=1)
    for k in reversed(range(len(steps))):
        d, codes = steps[k]
        g, dd = _level_step_bwd(saved[k], frozen_at[k], codes, dm[d], g)
        d_dm[d] = d_dm[d] + dd
        for _ in range(reps[k]):
            g = g.reshape(-1, 2).sum(dim=1)
    d_dm[0] = d_dm[0] + torch.sum(g)  # the root scalar starts at dm[0]
    return torch.stack(d_dm), d_leaf_adjust


class _DecodeLeafScalars(torch.autograd.Function):
    """The differentiable decode, its backward :func:`_decode_bwd`."""

    @staticmethod
    def forward(ctx, dm, leaf_adjust, spec_key, cut_depth, packed_levels, packed_chains):
        out, saved, pre_clip = _decode_fwd_res(spec_key, cut_depth, dm, leaf_adjust,
                                               packed_levels, packed_chains)
        ctx.spec_key, ctx.cut_depth = spec_key, cut_depth
        ctx.packed = (packed_levels, packed_chains)
        ctx.save_for_backward(dm, pre_clip, *saved)
        return out

    @staticmethod
    def backward(ctx, g):
        dm, pre_clip, *saved = ctx.saved_tensors
        d_dm, d_adj = _decode_bwd(ctx.spec_key, ctx.cut_depth, saved, pre_clip, dm, *ctx.packed,
                                  g)
        return d_dm, d_adj, None, None, None, None


def decode_leaf_scalars_diff(spec_key, cut_depth: int, dm: torch.Tensor,
                             leaf_adjust: torch.Tensor, packed_levels, packed_chains):
    """The differentiable decode to flat per-leaf scalars (float32,
    breadth-first leaf order, 0..255 units).  Differentiable with respect
    to ``dm`` (float32 (max_depth + 1,)) and ``leaf_adjust`` (float32
    (num_leaves,), added inside a final [0, 255] clamp).  ``spec_key`` is
    (dims, orig_depth, max_depth, schedule, chain_len); ``packed_levels``
    and ``packed_chains`` are a ``DeviceKdTree``'s streams."""
    return _DecodeLeafScalars.apply(dm, leaf_adjust, spec_key, int(cut_depth), packed_levels,
                                    packed_chains)


class DiffDecoder:
    """Differentiable view of a compressed tree: ``decoder(dm, leaf_adjust)``
    returns the decoded (Z, Y, X) float32 volume in [0, 1], differentiable
    with respect to both.  ``decoder.dm0`` is the tree's own distance map as
    float32 (where the decode equals ``level_cut_device(...) / 255``);
    ``leaf_adjust`` defaults to zeros (the identity).

    An image loss's gradient routes through here to the Δ map and the
    per-leaf scalars: compressed-domain fine-tuning, with no gradient of a
    dense parameter volume kept.  ``tree_or_dtree`` is a host ``KdTree``
    (put on ``device``) or a ``DeviceKdTree`` with its ``spec``."""

    def __init__(self, tree_or_dtree, spec: dict | None = None, cut_depth: int | None = None,
                 device: torch.device | str = "cuda"):
        if isinstance(tree_or_dtree, DeviceKdTree):
            if spec is None:
                raise ValueError("a DeviceKdTree needs its spec")
            self.dtree, self.spec = tree_or_dtree, spec
        else:
            self.dtree, self.spec = to_device(tree_or_dtree, device)
        self.cut_depth = self.spec["max_depth"] if cut_depth is None else int(cut_depth)
        self.spec_key = _spec_key(self.spec)
        self.num_leaves = 1 << self.spec["orig_depth"]

    @property
    def device(self) -> torch.device:
        return self.dtree.distance_map.device

    @property
    def dm0(self) -> torch.Tensor:
        return self.dtree.distance_map.to(torch.float32)

    def zero_leaf_adjust(self) -> torch.Tensor:
        return torch.zeros((self.num_leaves,), dtype=torch.float32, device=self.device)

    def __call__(self, dm: torch.Tensor, leaf_adjust: torch.Tensor | None = None) -> torch.Tensor:
        if leaf_adjust is None:
            leaf_adjust = self.zero_leaf_adjust()
        scalars = decode_leaf_scalars_diff(self.spec_key, self.cut_depth, dm, leaf_adjust,
                                           self.dtree.packed_levels, self.dtree.packed_chains)
        X, Y, Z = self.spec_key[0]
        perm, (nz, ny, nx) = _leaf_axes_perm(X, Y, Z, list(self.spec_key[3]))
        inv = [int(i) for i in np.argsort(perm)]
        vol = scalars.reshape((2,) * (nz + ny + nx)).permute(inv)
        return vol.reshape(Z, Y, X) / 255.0
