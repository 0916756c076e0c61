#!/usr/bin/env python
"""Micro-benchmarks for the memory-op candidates in the general-sparsity
(BAL) engine design: gather, segment-sum (sorted / unsorted keys), one-hot
matmul binning, cumsum-difference segment reduction, and row-bucket
reductions. Run on the GPU to pick the layout for solver/tiles.py.

Usage: python scripts/microbench_ops.py [--m 4000000] [--c 2048]
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, iters=5, warmup=2):
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.tree.map(lambda x: x.block_until_ready(), out)
    # force a value fetch so the timing includes the device work
    _ = float(jax.tree.leaves(out)[0].ravel()[0])
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.tree.map(lambda x: x.block_until_ready(), out)
    _ = float(jax.tree.leaves(out)[0].ravel()[0])
    return (time.time() - t0) / iters


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=4_000_000)
    p.add_argument("--n", type=int, default=400_000)
    p.add_argument("--c", type=int, default=2048)
    p.add_argument("--w", type=int, default=16)
    args = p.parse_args()
    M, N, C, W = args.m, args.n, args.c, args.w

    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)

    print(f"# platform={jax.devices()[0].platform} M={M} N={N} C={C} W={W}")

    vals16 = jax.random.normal(key, (M, 16), jnp.float32)
    vals3 = vals16[:, :3]
    table16 = jax.random.normal(key, (C, 16), jnp.float32)
    cam_ids = jnp.asarray(rng.integers(0, C, M), jnp.int32)
    pt_sorted = jnp.asarray(np.sort(rng.integers(0, N, M)), jnp.int32)

    # 1. row gather (M,16) from (C,16)
    f = jax.jit(lambda t, i: t[i])
    print(f"gather_(M,16)_from_(C,16): {timed(f, table16, cam_ids)*1e3:.2f} ms")

    # 2. segment-sum sorted ids (M,16) -> (N,16)
    f = jax.jit(lambda v, i: jax.ops.segment_sum(
        v, i, num_segments=N, indices_are_sorted=True))
    print(f"segsum_sorted_(M,16)->(N,16): {timed(f, vals16, pt_sorted)*1e3:.2f} ms")

    # 3. segment-sum unsorted ids (M,16) -> (C,16)
    f = jax.jit(lambda v, i: jax.ops.segment_sum(v, i, num_segments=C))
    print(f"segsum_unsorted_(M,16)->(C,16): {timed(f, vals16, cam_ids)*1e3:.2f} ms")

    # 4. cumsum-difference sorted segment sum: cumsum (M,16) + gather ends
    seg_ends = jnp.asarray(
        np.searchsorted(np.asarray(pt_sorted), np.arange(1, N + 1)) - 1,
        jnp.int32)

    def cumsum_seg(v):
        cs = jnp.cumsum(v, axis=0)
        ends = cs[seg_ends]
        return jnp.diff(ends, axis=0, prepend=jnp.zeros((1, v.shape[1]),
                                                        v.dtype))
    f = jax.jit(cumsum_seg)
    print(f"cumsum_seg_(M,16)->(N,16): {timed(f, vals16)*1e3:.2f} ms")

    # 5. one-hot matmul binning (M,16) -> (C,16), chunked, f32
    def onehot_bin(v, ids, dtype):
        B = 8192
        nch = M // B
        def chunk(c):
            vv, ii = c
            oh = (ii[:, None] == jax.lax.broadcasted_iota(
                jnp.int32, (B, C), 1)).astype(dtype)
            return jnp.dot(oh.T, vv.astype(dtype),
                           preferred_element_type=jnp.float32)
        parts = jax.lax.map(
            chunk, (v[: nch * B].reshape(nch, B, 16),
                    ids[: nch * B].reshape(nch, B)))
        return jnp.sum(parts, axis=0)
    for dt, name in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        f = jax.jit(lambda v, i, d=dt: onehot_bin(v, i, d))
        print(f"onehot_bin_{name}_(M,16)->(C,16): "
              f"{timed(f, vals16, cam_ids)*1e3:.2f} ms")

    # 6. one-hot LOOKUP (M,16) via (chunked) onehot @ table
    def onehot_lookup(ids, t, dtype):
        B = 8192
        nch = M // B
        def chunk(ii):
            oh = (ii[:, None] == jax.lax.broadcasted_iota(
                jnp.int32, (B, C), 1)).astype(dtype)
            return jnp.dot(oh, t.astype(dtype),
                           preferred_element_type=jnp.float32)
        return jax.lax.map(chunk, ids[: nch * B].reshape(nch, B))
    for dt, name in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        f = jax.jit(lambda i, t, d=dt: onehot_lookup(i, t, d))
        print(f"onehot_lookup_{name}_(M,16): "
              f"{timed(f, cam_ids, table16)*1e3:.2f} ms")

    # 7. bucket-row reduction (N, W, 16) -> (N, 16)  (point-major dense rows)
    rows = jax.random.normal(key, (M // W, W, 16), jnp.float32)
    f = jax.jit(lambda r: jnp.sum(r, axis=1))
    print(f"rowreduce_(M/W,W,16)->(.,16): {timed(f, rows)*1e3:.2f} ms")

    # 8. plane layout: W planes of (Nrow,) -> elementwise + reduce
    planes = jax.random.normal(key, (W, M // W), jnp.float32)
    f = jax.jit(lambda p: jnp.sum(p * p, axis=0))
    print(f"planereduce_(W,M/W)->(M/W,): {timed(f, planes)*1e3:.2f} ms")

    # 9. elementwise flops anchor: (M,16) fma chain x8
    def fma(v):
        x = v
        for _ in range(8):
            x = x * 1.0001 + 0.1
        return x
    f = jax.jit(fma)
    print(f"fma8_(M,16): {timed(f, vals16)*1e3:.2f} ms")

    # 10. big matmul anchor (8192x8192 @ 8192x8192 bf16)
    a = jax.random.normal(key, (8192, 8192), jnp.bfloat16)
    f = jax.jit(lambda x: jnp.dot(x, x, preferred_element_type=jnp.float32))
    t = timed(f, a)
    print(f"matmul_8192_bf16: {t*1e3:.2f} ms = {2*8192**3/t/1e12:.1f} TFLOP/s")


if __name__ == "__main__":
    main()
