"""I-frame (intra) block pipelines: batched encode/decode of macroblocks.

Batched formulation of the reference's per-block intra codec
(/root/reference/src/common.rs:141-152, 238-252, 287-298, 313-325): every
macroblock of a plane (or of all three planes concatenated) is processed in
one fused XLA program instead of a rayon fan-out.

Data layout: quantized coefficients are (N, 4, 64) int16 — N macroblocks in
raster order, 4 subblocks [TL, TR, BL, BR], 64 zigzag-order coefficients —
which flattens to the reference's 256-coefficients-per-block bitstream order
(enc.rs:246-257).
"""

from __future__ import annotations

import jax.numpy as jnp

from pfv_tpu.ops.blocks import blocks_to_subblocks, subblocks_to_blocks
from pfv_tpu.ops.dct import FP_BITS, fdct2d, idct2d
from pfv_tpu.ops.quant import dequantize, quantize


def encode_blocks(blocks: jnp.ndarray, q_table: jnp.ndarray) -> jnp.ndarray:
    """Intra-encode (N, 16, 16) uint8 macroblocks -> (N, 4, 64) int16 coeffs.

    Per subblock: center around 0 ((px - 128) << 8, common.rs:287-291), 2-D
    forward DCT, quantize. q_table broadcasts: (64,) for one plane, or
    (N, 1, 64) for per-block tables when planes are fused into one launch.
    """
    sub = blocks_to_subblocks(blocks.astype(jnp.int32))  # (N, 4, 8, 8)
    m = (sub - 128) << FP_BITS
    m = fdct2d(m)
    n = m.shape[0]
    return quantize(m.reshape(n, 4, 64), q_table)


def decode_blocks(coeffs: jnp.ndarray, q_table: jnp.ndarray) -> jnp.ndarray:
    """Intra-decode (N, 4, 64) int16 coeffs -> (N, 16, 16) uint8 macroblocks.

    Per subblock: dequantize, 2-D inverse DCT, (x >> 8) + 128 clamp 0..255
    (common.rs:313-325).
    """
    return decode_blocks_i32(coeffs, q_table).astype(jnp.uint8)


def decode_blocks_i32(coeffs: jnp.ndarray, q_table: jnp.ndarray) -> jnp.ndarray:
    """decode_blocks keeping the (0..255) pixels in i32.

    The fused-canvas decoder defers the u8 cast until after the final
    block->plane transpose and the residual arithmetic.
    """
    n = coeffs.shape[0]
    m = dequantize(coeffs, q_table)  # (N, 4, 64) i32 row-major
    m = idct2d(m.reshape(n, 4, 8, 8))
    px = jnp.clip((m >> FP_BITS) + 128, 0, 255)
    return subblocks_to_blocks(px)
