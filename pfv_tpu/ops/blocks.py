"""Macroblock layout transforms: plane <-> (N,16,16) blocks <-> (N,4,64) subblocks.

Batched replacement for the reference's per-block blit loops
(/root/reference/src/common.rs:83-105, 327-349): pure reshape/transpose ops
that XLA fuses into adjacent compute, turning the rayon fan-out over
macroblocks (common.rs:373-378) into a single batched tensor program.

Subblock order within a macroblock matches the reference (common.rs:141-152):
[top-left, top-right, bottom-left, bottom-right], each 8x8 row-major.
Block order within a plane is raster order (common.rs:364-370).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pad_dim(x: int, m: int = 16) -> int:
    """Padded size: x + (m - x % m) % m (reference common.rs:352-353)."""
    return x + (m - x % m) % m


def pad_plane(plane: jnp.ndarray, pad_h: int, pad_w: int, clear_color: int) -> jnp.ndarray:
    """Embed (H, W) plane into a (pad_h, pad_w) canvas filled with clear_color.

    Mirrors encode_plane's padded copy (common.rs:352-356): fill then blit the
    source into the top-left corner.
    """
    h, w = plane.shape
    return jnp.pad(
        plane,
        ((0, pad_h - h), (0, pad_w - w)),
        mode="constant",
        constant_values=clear_color,
    )


def plane_to_blocks(plane: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (H/16 * W/16, 16, 16) macroblocks in raster order."""
    h, w = plane.shape
    assert h % 16 == 0 and w % 16 == 0, (h, w)
    return (
        plane.reshape(h // 16, 16, w // 16, 16)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 16, 16)
    )


def blocks_to_plane(blocks: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """(N, 16, 16) raster-order macroblocks -> (h, w) plane."""
    assert h % 16 == 0 and w % 16 == 0, (h, w)
    return (
        blocks.reshape(h // 16, w // 16, 16, 16)
        .transpose(0, 2, 1, 3)
        .reshape(h, w)
    )


def blocks_to_subblocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """(N, 16, 16) -> (N, 4, 8, 8), subblocks in [TL, TR, BL, BR] order."""
    n = blocks.shape[0]
    return (
        blocks.reshape(n, 2, 8, 2, 8)
        .transpose(0, 1, 3, 2, 4)
        .reshape(n, 4, 8, 8)
    )


def subblocks_to_blocks(sub: jnp.ndarray) -> jnp.ndarray:
    """(N, 4, 8, 8) [TL, TR, BL, BR] -> (N, 16, 16)."""
    n = sub.shape[0]
    return (
        sub.reshape(n, 2, 2, 8, 8)
        .transpose(0, 1, 3, 2, 4)
        .reshape(n, 16, 16)
    )


def block_grid(h: int, w: int) -> tuple[int, int]:
    """(blocks_high, blocks_wide) for a padded plane."""
    return h // 16, w // 16


def block_origins(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Raster-order (by*16, bx*16) pixel origins for each macroblock."""
    bh, bw = block_grid(h, w)
    by, bx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
    return (by.reshape(-1) * 16).astype(np.int32), (bx.reshape(-1) * 16).astype(np.int32)
