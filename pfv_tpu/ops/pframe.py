"""P-frame (inter) block pipelines: residuals, delta encode/decode, batched.

Batched formulation of the reference's delta codec
(/root/reference/src/common.rs:98-123, 206-236, 254-285, 300-311). All
macroblocks of a plane run as one fused program; the skip-block decision
becomes a mask instead of control flow, keeping shapes static for XLA
(SURVEY.md §7 hard part 5).
"""

from __future__ import annotations

import jax.numpy as jnp

from pfv_tpu.ops.blocks import blocks_to_subblocks
from pfv_tpu.ops.dct import FP_BITS, fdct2d, tdiv_pow2
from pfv_tpu.ops.iframe import decode_blocks
from pfv_tpu.ops.motion import gather_predictions, motion_search
from pfv_tpu.ops.quant import quantize


def calc_residuals(cur_blocks: jnp.ndarray, pred_blocks: jnp.ndarray) -> jnp.ndarray:
    """(cur - pred).clamp(-255, 255) as i32 (common.rs:108-123)."""
    d = cur_blocks.astype(jnp.int32) - pred_blocks.astype(jnp.int32)
    return jnp.clip(d, -255, 255)


def encode_delta_blocks(residuals: jnp.ndarray, q_table: jnp.ndarray) -> jnp.ndarray:
    """Encode (N, 16, 16) i32 residuals -> (N, 4, 64) int16 coeffs.

    Residuals are halved with truncating division before the fixed-point
    shift ((x / 2) << 8, common.rs:300-311) so they fit the same dynamic
    range as intra blocks.
    """
    sub = blocks_to_subblocks(residuals)  # (N, 4, 8, 8) i32
    m = tdiv_pow2(sub, 1) << FP_BITS
    m = fdct2d(m)
    n = m.shape[0]
    return quantize(m.reshape(n, 4, 64), q_table)


def apply_residuals(res_u8: jnp.ndarray, pred_blocks: jnp.ndarray) -> jnp.ndarray:
    """Reconstruct: clamp(pred + (res - 128) * 2, 0, 255) (common.rs:98-105)."""
    d = (res_u8.astype(jnp.int32) - 128) * 2
    return jnp.clip(pred_blocks.astype(jnp.int32) + d, 0, 255).astype(jnp.uint8)


def decode_delta_blocks(
    coeffs: jnp.ndarray,
    q_table: jnp.ndarray,
    ref_plane: jnp.ndarray,
    by: jnp.ndarray,
    bx: jnp.ndarray,
    mv_y: jnp.ndarray,
    mv_x: jnp.ndarray,
    has_coeff: jnp.ndarray,
    mc_mode: str = "gather",
) -> jnp.ndarray:
    """Decode (N, 4, 64) delta coeffs -> (N, 16, 16) uint8 reconstructed blocks.

    Mirrors decode_block_delta (common.rs:254-285): fetch the prediction at
    (block origin + motion vector); if the block carries coefficients, decode
    the residual (same intra subblock decode) and apply it; otherwise the
    prediction passes through. Skipped blocks are handled by masking — their
    (all-zero) coefficients decode to dead values that `where` discards.

    mc_mode "mxu" uses the one-hot-matmul window extraction (full raster
    grid, |mv| <= 16 — always true for encoder-produced streams); "gather"
    handles the format's full mv range.
    """
    if mc_mode == "mxu":
        from pfv_tpu.ops.motion import predict_blocks_mxu

        pred = predict_blocks_mxu(ref_plane, mv_y, mv_x)
    else:
        pred = gather_predictions(ref_plane, by, bx, mv_y, mv_x)
    res_u8 = decode_blocks(coeffs, q_table)
    applied = apply_residuals(res_u8, pred)
    return jnp.where(has_coeff[:, None, None], applied, pred)


def encode_plane_delta(
    cur_blocks: jnp.ndarray,
    ref_plane: jnp.ndarray,
    by: jnp.ndarray,
    bx: jnp.ndarray,
    q_table: jnp.ndarray,
    min_err: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full inter-encode of one plane's macroblocks in one fused program.

    Mirrors encode_block_delta (common.rs:206-236): motion search, skip if
    the best SSD is already <= min_err (= px_err^2 * 256 computed in f32,
    enc.rs:41 + common.rs:209), otherwise encode halved residuals.

    Returns (coeffs (N,4,64) i16, mv_x (N,) i32, mv_y (N,) i32,
    has_coeff (N,) bool). Coefficients are computed densely for every block;
    the host drops them for skipped blocks when muxing.
    """
    mv_x, mv_y, best_err, best_win = motion_search(cur_blocks, ref_plane, by, bx)
    has_coeff = best_err.astype(jnp.float32) > min_err
    res = calc_residuals(cur_blocks, best_win)
    coeffs = encode_delta_blocks(res, q_table)
    return coeffs, mv_x, mv_y, has_coeff
