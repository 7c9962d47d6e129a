"""Fused per-frame decode step for NVIDIA GPUs (Pallas, Triton route).

One program reconstructs LANES // 4 macroblocks of one macroblock row of
the fused YUV canvas. Each of its LANES 8x8 subblocks owns one lane:

  gather the subblock's coefficients straight from the block-major dense
  coefficients (the same densify output the XLA steps read), dequantize
  (per-zigzag-slot multiplier, quirk Q1)
  -> 8x8 integer iDCT (columns, then rows; ops.dct.idct8_lanes), each
     pass one set of butterflies over (LANES, 8) register tiles
  -> motion-compensated prediction: per-pixel offset loads from the
     previous canvas at (y + dy, x + dx) (common.rs:254-261)
  -> residual apply / skip / intra select (common.rs:98-105)
  -> u8 stores.

Per frame and pixel that is one coefficient read, one previous-canvas
read (the canvas stays in L2) and one canvas write; the programs of a
frame are independent, and the frame loop is a `lax.scan` with one
`pallas_call` per frame and the canvas as the carry.

Operands of step(fidx, coeffs, meta, src, zz, mult, ftype, canvas):
* fidx: (1,) i32 frame index into the F axis of the per-frame operands.
* coeffs: (B, F, nb * 256) i16, stream block order, 4 subblocks x 64
  zigzag slots per block (the bitstream's own order).
* meta: (B, F, gch * gcw) i32 per canvas block, raster order:
  (dy + 128) | (dx + 128) << 8 | has_coeff << 16.
* src: (gch * gcw,) i32 stream block of each canvas block (nb for the
  canvas's dead filler blocks, which decode from zero coefficients).
* zz: (64,) i32 zigzag slot of each row-major coefficient position.
* mult: (B, F, 3 * 64) i32 dequant multipliers per plane and row-major
  position.
* ftype: (B, F) i32 (1 = intra).
* canvas: (B, chh, cw) u8 — Y on top, U | V side by side below.

B is a batch of independent streams (or GOPs) decoded in lockstep.
Motion windows never leave their own plane: the demux bounds-checks every
vector against its plane, so offset loads need no clamping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pfv_tpu.ops.dct import FP_BITS, idct8_lanes

LANES = 64  # subblocks per program: 16 macroblocks
NUM_WARPS = 4


def make_step(chh: int, cw: int, gly: int, glc: int, nb: int, *,
              interpret: bool = False):
    """Build step(fidx, coeffs, meta, src, zz, mult, ftype, canvas) ->
    canvas (operands in the module docstring).

    chh, cw: fused canvas rows and columns (multiples of 16); gly: luma
    macroblock rows (stripes below are chroma); glc: chroma plane width in
    macroblocks (V starts at canvas block column glc); nb: stream blocks
    per frame. interpret=True runs the kernel in the Pallas interpreter
    (CPU tests); otherwise it compiles for the GPU or the call raises.
    """
    gch, gcw = chh // 16, cw // 16
    ntiles = pl.cdiv(4 * gcw, LANES)

    def kernel(fi_ref, coef_ref, meta_ref, src_ref, zz_ref, mult_ref,
               ft_ref, prev_ref, out_ref):
        b = pl.program_id(0)
        row = pl.program_id(1)
        f = fi_ref[0]
        lane = pl.program_id(2) * LANES + jnp.arange(LANES, dtype=jnp.int32)
        gc = lane // 4
        sub = lane % 4
        live = gc < gcw
        blk = row * gcw + jnp.minimum(gc, gcw - 1)
        m = plgpu.load(meta_ref.at[b, f, blk])
        dy = ((m & 255) - 128)[:, None]
        dx = (((m >> 8) & 255) - 128)[:, None]
        coded = ((m >> 16) != 0)[:, None]
        intra = ft_ref[b, f] == 1
        s = plgpu.load(src_ref.at[blk])
        real = (s < nb)[:, None]
        base = (jnp.minimum(s, nb - 1) * 256 + sub * 64)[:, None]
        plane = jnp.where(row < gly, 0, jnp.where(gc < glc, 1, 2))[:, None]
        r8 = jnp.arange(8, dtype=jnp.int32)[None, :]

        # dequantized coefficients, one (LANES, 8) tile per row i
        x = []
        for i in range(8):
            zz = plgpu.load(zz_ref.at[pl.ds(8 * i, 8)])[None, :]
            q = plgpu.load(coef_ref.at[b, f, base + zz], mask=real, other=0)
            mul = plgpu.load(mult_ref.at[b, f, plane * 64 + 8 * i + r8])
            x.append(q.astype(jnp.int32) * mul)

        # column pass: butterflies across rows, elementwise over columns
        y = idct8_lanes(x)
        # transpose the 8x8 between the list axis and the tile axis
        i8 = jnp.arange(8, dtype=jnp.int32)[None, :, None]
        t = jnp.zeros((LANES, 8, 8), jnp.int32)
        for i in range(8):
            t = jnp.where(i8 == i, y[i][:, None, :], t)
        cols = [c.reshape(LANES, 8) for c in jnp.split(t, 8, axis=2)]
        # row pass: butterflies across columns; v[j][:, i] is pixel (i, j)
        v = idct8_lanes(cols)

        yy = (row * 16 + 8 * ((lane // 2) % 2))[:, None] + r8
        x0 = gc * 16 + 8 * (lane % 2)
        mask = live[:, None]
        for j in range(8):
            px = jnp.clip((v[j] >> FP_BITS) + 128, 0, 255)
            xx = (x0 + j)[:, None]
            pred = plgpu.load(prev_ref.at[b, yy + dy, xx + dx], mask=mask,
                              other=0).astype(jnp.int32)
            inter = jnp.where(
                coded, jnp.clip(pred + (px - 128) * 2, 0, 255), pred)
            out = jnp.where(intra, px, inter)
            plgpu.store(out_ref.at[b, yy, xx], out.astype(jnp.uint8),
                        mask=mask)

    def step(fidx, coeffs, meta, src, zz, mult, ftype, canvas):
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct(canvas.shape, jnp.uint8),
            grid=(canvas.shape[0], gch, ntiles),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name="pfv_decode_step",
        )(fidx, coeffs, meta, src, zz, mult, ftype, canvas)

    return step
