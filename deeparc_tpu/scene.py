"""Flat-array scene representation — the array replacement for the pointer graph.

The reference wires observations to parameters through a heap graph
(``ParameterBlock`` holding pointers into ``Intrinsic``/``Extrinsic``/
``Point3d`` storage, ``src/ParameterBlock.hh:68-94``). Here that becomes
indexed flat arrays (SURVEY.md section 7 design stance):

  * parameters: a :class:`BAParams` pytree of (N,3)/(E+1,3)/(K,2) tables;
  * structure: a :class:`SceneIndex` of int32 gather indices per observation
    plus alive-masks (removal = masking, not pointer surgery);
  * freezing/gauge: :func:`freeze_masks` — 0/1 pytree mirroring BAParams,
    the flat-array equivalent of ``SetParameterBlockConstant``
    (``src/sfm.cc:50-63``).

Extrinsic chain unification: every observation evaluates the composed model
``outer(inner(X))``. The extrinsic tables carry one extra frozen identity row
(index E) and single-extrinsic observations point their *inner* slot at it —
this collapses the reference's three runtime cases
(``ParameterBlock.hh:75-92``: ring==0 -> arc only; arc==0 -> ring only; else
compose) into one branch-free gather, with identical math.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeparc_tpu.io.deeparc_format import DeepArcData


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass
class BAParams:
    """Optimizable parameter tables (a pytree; leaves are jnp arrays)."""

    points: jnp.ndarray     # (N, 3)
    ext_rot: jnp.ndarray    # (E + 1, 3) angle-axis; row E is the identity slot
    ext_trans: jnp.ndarray  # (E + 1, 3)
    center: jnp.ndarray     # (K, 2) principal points
    focal: jnp.ndarray      # (K, 2)
    dist: jnp.ndarray       # (K, 2)


@_register
@dataclasses.dataclass
class SceneIndex:
    """Static observation structure (gather indices, masks, measurements)."""

    obs_point: jnp.ndarray   # (M,) int32
    obs_outer: jnp.ndarray   # (M,) int32 extrinsic row applied second (arc slot)
    obs_inner: jnp.ndarray   # (M,) int32 extrinsic row applied first (ring slot)
    obs_intr: jnp.ndarray    # (M,) int32
    obs_xy: jnp.ndarray      # (M, 2)
    obs_mask: jnp.ndarray    # (M,) 1.0 = alive
    point_mask: jnp.ndarray  # (N,) 1.0 = alive
    focal_shared: jnp.ndarray  # (K,) 1.0 when focal_size == 1
    dist_m1: jnp.ndarray     # (K,) 1.0 when dist_size >= 1
    dist_m2: jnp.ndarray     # (K,) 1.0 when dist_size == 2


@dataclasses.dataclass
class SceneMeta:
    """Host-side metadata needed to write results back (not traced)."""

    share_extrinsic: bool
    arc_size: int
    ring_size: int
    obs_arc: np.ndarray      # original first obs column (intrinsic / arc pos)
    obs_ring: np.ndarray     # original second obs column (extrinsic / ring pos)
    colors: np.ndarray       # (N, 3) int32
    focal_size: np.ndarray   # (K,) int32
    dist_size: np.ndarray    # (K,) int32
    version: float = 0.01


@dataclasses.dataclass
class Scene:
    params: BAParams
    index: SceneIndex
    meta: SceneMeta

    @property
    def n_obs(self) -> int:
        return int(self.index.obs_point.shape[0])

    @property
    def n_points(self) -> int:
        return int(self.params.points.shape[0])

    @property
    def n_extrinsics(self) -> int:  # excludes the identity slot
        return int(self.params.ext_rot.shape[0]) - 1

    @property
    def n_intrinsics(self) -> int:
        return int(self.params.center.shape[0])

    @property
    def identity_ext(self) -> int:
        return self.n_extrinsics


def from_deeparc(
    data: DeepArcData,
    dtype=jnp.float64,
    sort_by_point: bool = True,
) -> Scene:
    """Build a device Scene from parsed ``.deeparc`` contents.

    Mirrors ``DeepArcManager::buildParameterBlock`` wiring
    (``src/DeepArcManager.cc:173-196``): in shared mode the first obs column
    is both the intrinsic id and arc position (per-arc intrinsics shared
    around the ring, cc:210-214), the second is the ring position mapped to
    its extrinsic record (cc:166-171); in non-shared mode the columns are
    (intrinsic_id, extrinsic_id) directly.

    Observations are sorted by point id so per-point reductions are
    contiguous segments (the Schur elimination order).
    """
    E = data.n_extrinsics
    identity = E
    obs_arc = data.obs_arc.astype(np.int64)
    obs_ring = data.obs_ring.astype(np.int64)

    if data.share_extrinsic:
        ring_rec = np.where(obs_ring == 0, 0, obs_ring + data.arc_size - 1)
        # slot rules, ParameterBlock.hh:75-92
        outer = np.where(obs_ring == 0, obs_arc,
                         np.where(obs_arc == 0, ring_rec, obs_arc))
        inner = np.where((obs_ring == 0) | (obs_arc == 0), identity, ring_rec)
        intr = obs_arc
    else:
        outer = obs_ring            # extrinsic id column
        inner = np.full_like(outer, identity)
        intr = obs_arc              # intrinsic id column

    order = np.argsort(data.obs_point, kind="stable") if sort_by_point else (
        np.arange(data.n_obs)
    )

    params = BAParams(
        points=jnp.asarray(data.points, dtype),
        ext_rot=jnp.asarray(
            np.concatenate([data.ext_rot, np.zeros((1, 3))]), dtype
        ),
        ext_trans=jnp.asarray(
            np.concatenate([data.ext_trans, np.zeros((1, 3))]), dtype
        ),
        center=jnp.asarray(data.center, dtype),
        focal=jnp.asarray(data.focal, dtype),
        dist=jnp.asarray(data.dist, dtype),
    )
    index = SceneIndex(
        obs_point=jnp.asarray(data.obs_point[order], jnp.int32),
        obs_outer=jnp.asarray(outer[order], jnp.int32),
        obs_inner=jnp.asarray(inner[order], jnp.int32),
        obs_intr=jnp.asarray(intr[order], jnp.int32),
        obs_xy=jnp.asarray(data.obs_xy[order], dtype),
        obs_mask=jnp.ones(data.n_obs, dtype),
        point_mask=jnp.ones(data.n_points, dtype),
        focal_shared=jnp.asarray(data.focal_size == 1, dtype),
        dist_m1=jnp.asarray(data.dist_size >= 1, dtype),
        dist_m2=jnp.asarray(data.dist_size == 2, dtype),
    )
    meta = SceneMeta(
        share_extrinsic=data.share_extrinsic,
        arc_size=data.arc_size,
        ring_size=data.ring_size,
        obs_arc=data.obs_arc[order].copy(),
        obs_ring=data.obs_ring[order].copy(),
        colors=data.colors.copy(),
        focal_size=data.focal_size.copy(),
        dist_size=data.dist_size.copy(),
        version=data.version,
    )
    return Scene(params=params, index=index, meta=meta)


def to_deeparc(scene: Scene) -> DeepArcData:
    """Export back to host DeepArcData, dropping masked-out obs/points and
    re-indexing survivors (the writer's re-index, ``DeepArcManager.cc:429-432``).
    """
    obs_alive = np.asarray(scene.index.obs_mask) > 0.5
    pt_alive = np.asarray(scene.index.point_mask) > 0.5
    new_pt = np.cumsum(pt_alive) - 1
    obs_point = np.asarray(scene.index.obs_point)
    obs_alive = obs_alive & pt_alive[obs_point]

    return DeepArcData(
        version=scene.meta.version,
        share_extrinsic=scene.meta.share_extrinsic,
        arc_size=scene.meta.arc_size,
        ring_size=scene.meta.ring_size,
        obs_arc=scene.meta.obs_arc[obs_alive].astype(np.int32),
        obs_ring=scene.meta.obs_ring[obs_alive].astype(np.int32),
        obs_point=new_pt[obs_point[obs_alive]].astype(np.int32),
        obs_xy=np.asarray(scene.index.obs_xy)[obs_alive],
        center=np.asarray(scene.params.center),
        focal=np.asarray(scene.params.focal),
        focal_size=scene.meta.focal_size,
        dist=np.asarray(scene.params.dist),
        dist_size=scene.meta.dist_size,
        ext_rot=np.asarray(scene.params.ext_rot)[:-1],
        ext_trans=np.asarray(scene.params.ext_trans)[:-1],
        points=np.asarray(scene.params.points)[pt_alive],
        colors=scene.meta.colors[pt_alive],
    )


def compact(scene: Scene, obs_bucket: int = 1, point_bucket: int = 1) -> Scene:
    """Physically drop masked-out observations/points and re-index.

    The flat-array replacement for the reference's erase/cascade-delete passes
    (``DeepArcManager.cc:355-421``). Bucket sizes round the new M / N up (with
    masked padding) so repeated filtering triggers a bounded number of XLA
    recompilations.
    """
    obs_alive = np.asarray(scene.index.obs_mask) > 0.5
    pt_alive = np.asarray(scene.index.point_mask) > 0.5
    obs_point = np.asarray(scene.index.obs_point)
    obs_alive = obs_alive & pt_alive[obs_point]
    new_pt = np.cumsum(pt_alive) - 1

    n_obs = int(obs_alive.sum())
    n_pts = int(pt_alive.sum())
    M = -(-n_obs // obs_bucket) * obs_bucket
    N = max(-(-n_pts // point_bucket) * point_bucket, 1)

    def pad_obs(arr, fill):
        arr = np.asarray(arr)[obs_alive]
        pad_shape = (M - n_obs,) + arr.shape[1:]
        return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])

    dtype = scene.params.points.dtype
    points = np.asarray(scene.params.points)[pt_alive]
    points = np.concatenate(
        [points, np.zeros((N - n_pts, 3), points.dtype)]
    )
    point_mask = np.concatenate(
        [np.ones(n_pts), np.zeros(N - n_pts)]
    )

    index = SceneIndex(
        obs_point=jnp.asarray(
            pad_obs(new_pt[obs_point].astype(np.int32), 0), jnp.int32
        ),
        obs_outer=jnp.asarray(pad_obs(scene.index.obs_outer, scene.identity_ext), jnp.int32),
        obs_inner=jnp.asarray(pad_obs(scene.index.obs_inner, scene.identity_ext), jnp.int32),
        obs_intr=jnp.asarray(pad_obs(scene.index.obs_intr, 0), jnp.int32),
        obs_xy=jnp.asarray(pad_obs(scene.index.obs_xy, 0.0), dtype),
        obs_mask=jnp.asarray(pad_obs(np.ones(scene.n_obs), 0.0), dtype),
        point_mask=jnp.asarray(point_mask, dtype),
        focal_shared=scene.index.focal_shared,
        dist_m1=scene.index.dist_m1,
        dist_m2=scene.index.dist_m2,
    )
    params = dataclasses.replace(scene.params, points=jnp.asarray(points, dtype))
    meta = dataclasses.replace(
        scene.meta,
        obs_arc=pad_obs(scene.meta.obs_arc, 0),
        obs_ring=pad_obs(scene.meta.obs_ring, 0),
        colors=np.concatenate(
            [scene.meta.colors[pt_alive],
             np.zeros((N - n_pts, 3), scene.meta.colors.dtype)]
        ),
    )
    return Scene(params=params, index=index, meta=meta)


def freeze_masks(
    scene: Scene,
    freeze_camera: bool = False,
    gauge_fix_first_extrinsic: bool = True,
    optimize_intrinsics: bool = False,
    freeze_points: bool = False,
) -> BAParams:
    """0/1 masks (1 = free) mirroring BAParams — the flat-array equivalent of
    ``SetParameterBlockConstant`` as the reference applies it:

      * extrinsic record 0 — the camera-(0,0) / world-gauge extrinsic — is
        held constant (``src/sfm.cc:50-53``);
      * intrinsics (principal, focal, distortion) are held constant in BOTH
        the freeze and full branches (``src/sfm.cc:60-62``), so
        ``optimize_intrinsics`` defaults to False;
      * ``freeze_camera=True`` holds everything but the points constant
        (``src/sfm.cc:54-57`` — the triangulation-only pre-solve);
      * the identity slot (row E) is always frozen.
    """
    p = scene.params
    ones = lambda a: jnp.ones(a.shape, a.dtype)
    zeros = lambda a: jnp.zeros(a.shape, a.dtype)

    ext_free = ones(p.ext_rot)
    ext_free = ext_free.at[scene.identity_ext].set(0.0)
    if gauge_fix_first_extrinsic:
        ext_free = ext_free.at[0].set(0.0)
    if freeze_camera:
        ext_free = zeros(p.ext_rot)

    intr_free = (not freeze_camera) and optimize_intrinsics
    intr = ones(p.center) if intr_free else zeros(p.center)
    focal = ones(p.focal) if intr_free else zeros(p.focal)
    dist = ones(p.dist) if intr_free else zeros(p.dist)
    if intr_free:
        # Structurally absent slots stay frozen (focal[1] when shared,
        # missing distortion coefficients).
        focal = focal * jnp.stack(
            [jnp.ones_like(scene.index.focal_shared),
             1.0 - scene.index.focal_shared], axis=1)
        dist = dist * jnp.stack(
            [scene.index.dist_m1, scene.index.dist_m2], axis=1)

    points = zeros(p.points) if freeze_points else (
        ones(p.points) * scene.index.point_mask[:, None]
    )
    return BAParams(
        points=points,
        ext_rot=ext_free,
        ext_trans=ext_free,
        center=intr,
        focal=focal,
        dist=dist,
    )
