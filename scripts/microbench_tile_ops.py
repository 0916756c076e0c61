#!/usr/bin/env python
"""Microbenchmark the candidate primitives for the tile-engine sweeps.

The tile engine's PCG sweep must, per observation slot: read an 18-wide
cell-space vector, do ~100 flops of einsum work, and bin an 18-wide
contribution back to cell space. This script prices every way to do the
read and the write at BAL scale (M = 8M slots, V = 2000 cells) on the real
chip, so the sweep design is chosen from measurements, not guesses
(the round-2 numbers in solver/tiles.py:8-15 were taken at M = 4M / 16-wide).

Run: python scripts/microbench_tile_ops.py [--m 8000000] [--v 2000]
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=5, warmup=2):
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    # force a value fetch so the timing includes the device work
    _ = float(jnp.sum(jax.tree.leaves(out)[0][..., 0].ravel()[:1]))
    f = jax.jit(fn)
    for _ in range(warmup):
        out = f(*args)
    _ = float(jnp.sum(jax.tree.leaves(out)[0][..., 0].ravel()[:1]))
    t0 = time.time()
    for _ in range(reps):
        out = f(*args)
    _ = float(jnp.sum(jax.tree.leaves(out)[0][..., 0].ravel()[:1]))
    return (time.time() - t0) / reps


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=8_388_608)  # multiple of 8192
    p.add_argument("--v", type=int, default=2000)
    p.add_argument("--w", type=int, default=8)
    args = p.parse_args()
    M, V, W = -(-args.m // 8192) * 8192, args.v, args.w
    R = M // W

    key = jax.random.PRNGKey(0)
    cell = jax.random.randint(key, (M,), 0, V, jnp.int32)
    cell_rows = cell.reshape(R, W)
    table18 = jax.random.normal(key, (V, 18), jnp.float32)
    table78 = jax.random.normal(key, (V, 78), jnp.float32)
    u18 = jax.random.normal(key, (M, 18), jnp.float32)
    u2 = jax.random.normal(key, (M, 2), jnp.float32)
    perm = jax.random.permutation(key, M)
    rows18 = u18.reshape(R, W, 18)

    results = {}

    def rec(name, secs, bytes_moved=None, flops=None):
        results[name] = secs
        extra = ""
        if bytes_moved:
            extra += f"  {bytes_moved / secs / 1e9:8.1f} GB/s"
        if flops:
            extra += f"  {flops / secs / 1e12:8.2f} TFLOP/s"
        print(f"{name:44s} {secs * 1e3:9.2f} ms{extra}", flush=True)

    def onehot(ids, V, dtype):
        iota = jax.lax.broadcasted_iota(jnp.int32, (ids.shape[0], V), 1)
        return (ids[:, None] == iota).astype(dtype)

    # ---- READ direction: per-slot cell-space lookup -------------------------
    rec("gather (M,18) <- (V,18)",
        timeit(lambda c, t: t[c], cell, table18), bytes_moved=M * 18 * 4)
    rec("gather (M,78) <- (V,78)",
        timeit(lambda c, t: t[c], cell, table78), bytes_moved=M * 78 * 4)
    rec("take (M,18) <- (V,18)",
        timeit(lambda c, t: jnp.take(t, c, axis=0), cell, table18),
        bytes_moved=M * 18 * 4)

    def oh_read(c, t):
        def chunk(cc):
            return jnp.dot(onehot(cc, V, jnp.float32), t,
                           preferred_element_type=jnp.float32)
        return jax.lax.map(chunk, c.reshape(-1, 8192))
    rec("one-hot read (M,18), 8k chunks",
        timeit(oh_read, cell, table18), flops=2 * M * V * 18)

    # row-broadcast read: one cell per row of W slots (cam-major pattern)
    cell_r = cell_rows[:, 0]
    rec("row-broadcast read (R,18)[row_cell]",
        timeit(lambda c, t: t[c], cell_r, table18), bytes_moved=R * 18 * 4)

    # ---- PERMUTE: point-major <-> cam-major intermediates --------------------
    rec("permute gather (M,2)",
        timeit(lambda p, x: x[p], perm, u2), bytes_moved=M * 2 * 4 * 2)
    rec("permute gather (M,18)",
        timeit(lambda p, x: x[p], perm, u18), bytes_moved=M * 18 * 4 * 2)

    # ---- WRITE direction: bin (M,18) -> (V,18) -------------------------------
    def oh_bin(c, x):
        def chunk(arg):
            cc, xx = arg
            return jnp.dot(onehot(cc, V, jnp.float32).T, xx,
                           preferred_element_type=jnp.float32)
        parts = jax.lax.map(
            chunk, (c.reshape(-1, 8192), x.reshape(-1, 8192, 18)))
        return jnp.sum(parts, axis=0)
    rec("one-hot bin (M,18)->(V,18), 8k chunks",
        timeit(oh_bin, cell, u18), flops=2 * M * V * 18)

    rec("scatter-add (M,18)->(V,18)",
        timeit(lambda c, x: jnp.zeros((V, 18), jnp.float32).at[c].add(x),
               cell, u18), bytes_moved=M * 18 * 4)
    rec("segment-sum sorted (M,18)->(V,18)",
        timeit(lambda c, x: jax.ops.segment_sum(x, c, num_segments=V),
               jnp.sort(cell), u18), bytes_moved=M * 18 * 4)
    rec("within-row reduce (R,W,18)->(R,18)",
        timeit(lambda x: jnp.sum(x, axis=1), rows18),
        bytes_moved=M * 18 * 4)
    cell_small = cell[: R]
    u_small = u18[: R]
    rec("scatter-add rows (R,18)->(V,18)",
        timeit(lambda c, x: jnp.zeros((V, 18), jnp.float32).at[c].add(x),
               cell_small, u_small), bytes_moved=R * 18 * 4)

    # ---- einsum payload work at M scale (the irreducible part) --------------
    jcam = jax.random.normal(key, (R, W, 2, 18), jnp.float32)
    vsl = jax.random.normal(key, (R, W, 18), jnp.float32)
    rec("einsum rwkc,rwc->rwk (J_cam . v)",
        timeit(lambda a, b: jnp.einsum("rwkc,rwc->rwk", a, b), jcam, vsl),
        flops=2 * M * 36, bytes_moved=M * (36 + 18 + 2) * 4)
    rec("einsum rwkc,rwk->rwc (J_cam^T t)",
        timeit(lambda a, b: jnp.einsum("rwkc,rwk->rwc", a, b), jcam,
               jax.random.normal(key, (R, W, 2), jnp.float32)),
        flops=2 * M * 36, bytes_moved=M * (36 + 2 + 18) * 4)

    print()
    print({k: round(v * 1e3, 2) for k, v in results.items()})


if __name__ == "__main__":
    main()
