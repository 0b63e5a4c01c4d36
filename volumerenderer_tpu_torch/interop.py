"""Bringing a JAX run's state into the port.

The renderer's inputs play the part of a model's weights: a volume, a ray
bundle, the transfer-function parameters and a compressed kd-tree.  A JAX
run hands them over as numpy arrays (``np.asarray`` of its jax arrays) and
its camera and trees as the fields of their dataclasses; these functions turn
them into the port's tensors, ``Camera``, ``TFParams``, ``KdTree``,
``MidRangeTree``, ``HashedKdTree`` and ``Octree``, and its configuration
(``AppConfig``) as nested dicts.  The other carrier is the checkpoint file
(``codecs.kdtree.save``): a file written by either package opens in the
other.
"""
from __future__ import annotations

import numpy as np
import torch

import dataclasses

from .camera import Camera, RayBundle
from .codecs.hashed import HashedKdTree
from .codecs.kdtree import KdTree
from .codecs.midrange import MidRangeTree
from .codecs.octree import Octree
from .config import AppConfig, CodecConfig, DatasetConfig, DistributedConfig, RenderConfig
from .diff.transfer import TFParams
from .ops.sampling import as_normalized_volume

__all__ = ["volume_from_numpy", "rays_from_numpy", "camera_from_jax_fields",
           "tf_params_from_numpy", "kdtree_from_numpy", "midrange_from_numpy",
           "hashed_from_numpy", "octree_from_numpy", "app_config_from_jax_fields"]


def volume_from_numpy(arr: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """(Z, Y, X) uint8 or float32 array -> float32 volume in [0, 1] on
    ``device`` (bytes are normalized by 255, floats are taken as they are)."""
    arr = np.asarray(arr)
    if arr.ndim != 3 or arr.dtype not in (np.uint8, np.float32):
        raise ValueError(f"expected a (Z, Y, X) uint8 or float32 array, got "
                         f"{arr.shape} {arr.dtype}")
    return as_normalized_volume(arr, device=device)


def rays_from_numpy(entry_uv: np.ndarray, direction: np.ndarray, hit: np.ndarray,
                    device: torch.device | str = "cuda") -> RayBundle:
    """(H, W, 3) entry points and directions and an (H, W) hit mask ->
    a ``RayBundle`` of float32 / bool tensors on ``device``."""
    entry_uv = np.asarray(entry_uv, dtype=np.float32)
    direction = np.asarray(direction, dtype=np.float32)
    hit = np.asarray(hit)
    if entry_uv.ndim != 3 or entry_uv.shape[-1] != 3 or direction.shape != entry_uv.shape \
            or hit.shape != entry_uv.shape[:-1]:
        raise ValueError(f"expected (H, W, 3), (H, W, 3), (H, W); got {entry_uv.shape}, "
                         f"{direction.shape}, {hit.shape}")
    return RayBundle(entry_uv=torch.tensor(entry_uv, device=device),
                     direction=torch.tensor(direction, device=device),
                     hit=torch.tensor(hit != 0, device=device))


def camera_from_jax_fields(**fields) -> Camera:
    """``camera_from_jax_fields(**dataclasses.asdict(jax_camera))``: the same
    camera in the port.  Unknown fields raise ``TypeError``."""
    vectors = {k: tuple(float(x) for x in v) for k, v in fields.items()
               if k in ("position", "front", "up")}
    return Camera(**{**fields, **vectors})


def tf_params_from_numpy(device: torch.device | str = "cuda", **fields) -> TFParams:
    """``tf_params_from_numpy(**{k: np.asarray(v) for k, v in
    jax_params._asdict().items()})``: the JAX ``TFParams`` as the port's, in
    float32 on ``device``.  Every field is required; an unknown or
    misshapen one raises."""
    if set(fields) != set(TFParams._fields):
        raise TypeError(f"expected the fields {TFParams._fields}, got {tuple(fields)}")
    shapes = {"alpha_scale": (), "color_gain": (), "color_bias": (), "flip_sign": (3,),
              "flip_bias": (3,)}
    out = {}
    for name, want in shapes.items():
        arr = np.asarray(fields[name], dtype=np.float32)
        if arr.shape != want:
            raise ValueError(f"{name} must have shape {want}, got {arr.shape}")
        out[name] = torch.tensor(arr, device=device)
    return TFParams(**out)


def _check_fields(cls, fields) -> None:
    names = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != names:
        raise TypeError(f"expected the fields {sorted(names)}, got {sorted(fields)}")


def kdtree_from_numpy(**fields) -> KdTree:
    """``kdtree_from_numpy(**dataclasses.asdict(jax_tree))``: a JAX-built
    ``KdTree`` as the port's, its arrays copied.  Every field is required;
    an unknown one raises ``TypeError``."""
    _check_fields(KdTree, fields)

    def copy(a, dtype):
        return None if a is None else np.array(a, dtype=dtype)

    return KdTree(
        dims=tuple(int(d) for d in fields["dims"]), orig_depth=int(fields["orig_depth"]),
        max_depth=int(fields["max_depth"]),
        distance_map=copy(fields["distance_map"], np.uint8),
        level_codes=[copy(c, np.uint8) for c in fields["level_codes"]],
        chain_codes=copy(fields["chain_codes"], np.uint8),
        schedule=[int(s) for s in fields["schedule"]], tolerance=int(fields["tolerance"]),
        max_epochs=int(fields["max_epochs"]),
        num_active_nodes=int(fields["num_active_nodes"]),
        leaf_recon=copy(fields["leaf_recon"], np.int32),
        leaf_truth=copy(fields["leaf_truth"], np.uint8))


def midrange_from_numpy(**fields) -> MidRangeTree:
    """``midrange_from_numpy(**dataclasses.asdict(jax_tree))``: a JAX-built
    ``MidRangeTree`` as the port's, its arrays copied.  ``mid`` is the
    midpoint channel's fields as a dict (what ``dataclasses.asdict`` makes
    of it; see :func:`kdtree_from_numpy`) or a port ``KdTree``.  Every field
    is required; an unknown one raises ``TypeError``."""
    _check_fields(MidRangeTree, fields)
    mid = fields["mid"]
    if not isinstance(mid, KdTree):
        mid = kdtree_from_numpy(**mid)

    def copy(a, dtype):
        return None if a is None else np.array(a, dtype=dtype)

    return MidRangeTree(
        mid=mid, range_distance_map=copy(fields["range_distance_map"], np.uint8),
        range_level_codes=[copy(c, np.uint8) for c in fields["range_level_codes"]],
        range_chain_codes=copy(fields["range_chain_codes"], np.uint8),
        leaf_recon_range=copy(fields["leaf_recon_range"], np.int32),
        leaf_truth_range=copy(fields["leaf_truth_range"], np.int32))


def hashed_from_numpy(**fields) -> HashedKdTree:
    """``hashed_from_numpy(**dataclasses.asdict(jax_tree))``: a JAX-built
    ``HashedKdTree`` as the port's, its arrays copied.  Every field is
    required; an unknown one raises ``TypeError``."""
    _check_fields(HashedKdTree, fields)
    arrays = {"distance_map": np.uint8, "tree_data": np.uint8, "tree_structure": np.uint8,
              "coll_keys": np.int64, "coll_vals": np.int32, "coll_data": np.uint8,
              "coll_structure": np.uint8}
    return HashedKdTree(
        dims=tuple(int(d) for d in fields["dims"]), orig_depth=int(fields["orig_depth"]),
        tree_depth=int(fields["tree_depth"]), hash_mask=int(fields["hash_mask"]),
        tolerance=int(fields["tolerance"]),
        **{k: np.array(fields[k], dtype=t) for k, t in arrays.items()})


def octree_from_numpy(**fields) -> Octree:
    """``octree_from_numpy(**dataclasses.asdict(jax_tree))``: a JAX-built
    ``Octree`` as the port's, its level arrays copied.  Every field is
    required; an unknown one raises ``TypeError``."""
    _check_fields(Octree, fields)
    return Octree(dims=tuple(int(d) for d in fields["dims"]),
                  start_depth=int(fields["start_depth"]), depth=int(fields["depth"]),
                  split_dims=[int(a) for a in fields["split_dims"]],
                  level_scalars=[np.array(s, dtype=np.uint8) for s in fields["level_scalars"]])


def app_config_from_jax_fields(**fields) -> AppConfig:
    """``app_config_from_jax_fields(**dataclasses.asdict(jax_config))``: a
    JAX ``AppConfig`` (nested dicts, tuples or lists) as the port's, the
    camera through :func:`camera_from_jax_fields`.  Every field is required;
    an unknown one raises ``TypeError``."""
    _check_fields(AppConfig, fields)
    render = dict(fields["render"])
    _check_fields(RenderConfig, render)
    render["camera"] = camera_from_jax_fields(**render["camera"])
    dataset = dict(fields["dataset"])
    _check_fields(DatasetConfig, dataset)
    for k in ("brick_dims", "volume_grid", "load_grid", "synthetic_dims"):
        dataset[k] = tuple(int(v) for v in dataset[k])
    for cls, name in ((CodecConfig, "codec"), (DistributedConfig, "distributed")):
        _check_fields(cls, fields[name])
    return AppConfig(render=RenderConfig(**render), codec=CodecConfig(**fields["codec"]),
                     dataset=DatasetConfig(**dataset),
                     distributed=DistributedConfig(**fields["distributed"]),
                     tree_path=fields["tree_path"])
