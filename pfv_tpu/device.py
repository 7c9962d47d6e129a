"""Jitted device pipelines: whole-plane encode/decode steps.

Each function processes every macroblock of a plane as one XLA program —
the batched replacement for the reference's rayon fan-out
(/root/reference/src/common.rs:351-521). jax.jit caches compilations per
plane shape (one luma + one chroma shape per video).

The encoder steps fuse in-loop reconstruction (enc.rs:84-97, 134-147): the
reconstructed previous frame never leaves the device between frames.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pfv_tpu.ops.blocks import block_origins, blocks_to_plane, plane_to_blocks
from pfv_tpu.ops.iframe import decode_blocks, encode_blocks
from pfv_tpu.ops.pframe import decode_delta_blocks, encode_plane_delta


def origins_for(h: int, w: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    by, bx = block_origins(h, w)
    return jnp.asarray(by), jnp.asarray(bx)


@jax.jit
def iframe_encode_plane(plane: jnp.ndarray, q_table: jnp.ndarray):
    """Padded (H, W) u8 plane -> ((N, 256) i16 coeffs, (H, W) u8 recon).

    Encode + in-loop decode in one program (enc.rs:84-85).
    """
    h, w = plane.shape
    blocks = plane_to_blocks(plane)
    coeffs = encode_blocks(blocks, q_table)  # (N, 4, 64)
    recon = blocks_to_plane(decode_blocks(coeffs, q_table), h, w)
    return coeffs.reshape(coeffs.shape[0], 256), recon


@jax.jit
def iframe_decode_plane(coeffs: jnp.ndarray, q_table: jnp.ndarray, like: jnp.ndarray):
    """(N, 256) i16 coeffs -> padded (H, W) u8 plane (shape taken from `like`)."""
    h, w = like.shape
    n = coeffs.shape[0]
    blocks = decode_blocks(coeffs.reshape(n, 4, 64), q_table)
    return blocks_to_plane(blocks, h, w)


@jax.jit
def pframe_encode_plane(
    plane: jnp.ndarray,
    ref_plane: jnp.ndarray,
    q_table: jnp.ndarray,
    min_err: jnp.ndarray,
    by: jnp.ndarray,
    bx: jnp.ndarray,
):
    """Inter-encode one padded plane against the reconstructed previous plane.

    Returns (coeffs (N, 256) i16, mv_x (N,) i8, mv_y (N,) i8,
    has_coeff (N,) bool, recon (H, W) u8). Mirrors encode_plane_delta +
    in-loop decode_plane_delta (enc.rs:134-147).
    """
    h, w = plane.shape
    blocks = plane_to_blocks(plane)
    coeffs, mv_x, mv_y, has_coeff = encode_plane_delta(
        blocks, ref_plane, by, bx, q_table, min_err
    )
    # own motion vectors are <= 15, so the in-loop recon can use the
    # one-hot-matmul window extraction
    recon_blocks = decode_delta_blocks(
        coeffs, q_table, ref_plane, by, bx, mv_y, mv_x, has_coeff,
        mc_mode="mxu",
    )
    recon = blocks_to_plane(recon_blocks, h, w)
    n = coeffs.shape[0]
    return (
        coeffs.reshape(n, 256),
        mv_x.astype(jnp.int8),
        mv_y.astype(jnp.int8),
        has_coeff,
        recon,
    )


@jax.jit
def pframe_decode_plane(
    coeffs: jnp.ndarray,
    mvx: jnp.ndarray,
    mvy: jnp.ndarray,
    has_coeff: jnp.ndarray,
    ref_plane: jnp.ndarray,
    q_table: jnp.ndarray,
    by: jnp.ndarray,
    bx: jnp.ndarray,
):
    """(N, 256) coeffs + headers -> reconstructed padded (H, W) u8 plane."""
    h, w = ref_plane.shape
    n = coeffs.shape[0]
    blocks = decode_delta_blocks(
        coeffs.reshape(n, 4, 64),
        q_table,
        ref_plane,
        by,
        bx,
        mvy.astype(jnp.int32),
        mvx.astype(jnp.int32),
        has_coeff.astype(bool),
    )
    return blocks_to_plane(blocks, h, w)


@jax.jit
def plane_mse(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Mean squared error between two u8 planes (for encoder PSNR stats)."""
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.mean(d * d)


def pad_plane_host(plane: np.ndarray, pad_h: int, pad_w: int, clear: int) -> jnp.ndarray:
    """Pad an unpadded host plane into a device array (common.rs:352-356)."""
    h, w = plane.shape
    if h == pad_h and w == pad_w:
        return jnp.asarray(plane)
    out = np.full((pad_h, pad_w), clear, dtype=np.uint8)
    out[:h, :w] = plane
    return jnp.asarray(out)
