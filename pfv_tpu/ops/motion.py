"""Motion estimation: batched 4-step logarithmic block search.

Batched reformulation of the reference's recursive per-block search
(/root/reference/src/common.rs:154-236). The recursion over step sizes
8 -> 4 -> 2 -> 1 is unrolled; at each level all N macroblocks evaluate all 9
candidates as one batched gather + SSD reduction.

Bit-exactness notes (SURVEY.md Q7/Q9):
* SSDs are integer-valued and < 2^24, so i32 accumulation reproduces the
  reference's sequential f32 sums exactly; the early-exit never changes the
  argmin.
* Tie-breaking: the reference tests the center first and requires a strict
  improvement (`err < best_err`, common.rs:189), scanning neighbors in
  (my, mx) row-major order. We reproduce this by composing a lexicographic
  score = err * 16 + candidate_priority.
* Candidates whose 16x16 window would leave the (padded) plane are skipped,
  not clamped (common.rs:170-183). The center is always in bounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Candidate offsets in priority order: center first (tested first), then the
# 3x3 neighborhood in the reference's loop order (my outer, mx inner,
# skipping the center; common.rs:168-196).
_CAND_MX = np.array([0, -1, 0, 1, -1, 1, -1, 0, 1], dtype=np.int32)
_CAND_MY = np.array([0, -1, -1, -1, 0, 0, 1, 1, 1], dtype=np.int32)

_I32_MAX = np.int32(np.iinfo(np.int32).max)


def _gather_window(ref_plane: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Dynamic 16x16 window at (y, x); out-of-range starts clamp (masked later)."""
    return jax.lax.dynamic_slice(ref_plane, (y, x), (16, 16))


_gather_windows = jax.vmap(jax.vmap(_gather_window, in_axes=(None, 0, 0)), in_axes=(None, 0, 0))


# ---------------------------------------------------------------------------
# Window extraction as one-hot matmuls over static 48x48 patches.
#
# For |offset| <= 16 every block's window lies inside a static 48x48 patch
# centered on the block, so window extraction becomes two batched matmuls
# with one-hot row/column selectors instead of a gather. Exact: each
# output is a sum of exactly one patch value (one-hot rows), accumulated
# in s32.
# ---------------------------------------------------------------------------


def block_patches(ref_plane: jnp.ndarray) -> jnp.ndarray:
    """(H, W) plane -> (N, 48, 48) int8 patches (values - 128), patch b
    centered on block b.

    patches[b, 16+u, 16+v] = ref[by_b + u, bx_b + v] - 128 for u, v in
    [-16, 32) (-128 outside the plane), assembled from 9 static shifted
    tilings — no gather anywhere. The -128 centering puts u8 pixels in
    int8 range so the one-hot window selection runs as exact s8 x s8 ->
    s32 matmuls."""
    h, w = ref_plane.shape
    gh, gw = h // 16, w // 16
    padded = jnp.pad(ref_plane, 16)
    pieces = jnp.stack([
        padded[16 * a : 16 * a + h, 16 * b : 16 * b + w]
        for a in range(3)
        for b in range(3)
    ])  # (9, H, W) u8
    p = (pieces.astype(jnp.int32) - 128).astype(jnp.int8)
    p = p.reshape(3, 3, gh, 16, gw, 16)
    return p.transpose(2, 4, 0, 3, 1, 5).reshape(gh * gw, 48, 48)


def onehot_windows(
    patches: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray
) -> jnp.ndarray:
    """Select each block's 16x16 window at offset (dy, dx) in [-16, 16].

    patches: (N, 48, 48) int8 (values - 128) from block_patches. Returns
    (N, 16, 16) int32 windows holding exact pixel values 0..255 (128 for
    offsets outside the patch — unreachable for bounds-checked streams).
    Both dots are s8 x s8 with s32 accumulation: every output is one
    selected patch value, so the arithmetic is exact."""
    r = 16 + dy[:, None] + jnp.arange(16, dtype=jnp.int32)[None, :]
    c = 16 + dx[:, None] + jnp.arange(16, dtype=jnp.int32)[None, :]
    k = jnp.arange(48, dtype=jnp.int32)
    sel_r = (r[:, :, None] == k[None, None, :]).astype(jnp.int8)
    sel_c = (c[:, :, None] == k[None, None, :]).astype(jnp.int8)
    t = jnp.einsum(
        "nik,nkl->nil", sel_r, patches, preferred_element_type=jnp.int32
    ).astype(jnp.int8)  # selected rows: still s8 range (values - 128)
    w = jnp.einsum(
        "nil,njl->nij", t, sel_c, preferred_element_type=jnp.int32
    )
    return w + 128


def predict_plane_select(
    canvas: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray
) -> jnp.ndarray:
    """Motion-compensated prediction of a whole plane, band-select form.

    canvas: (H, W) uint8 (H, W multiples of 16). dy, dx: (H/16, W/16) i32
    per-block motion, |mv| <= 16, every window inside the plane (the demux
    bounds-validates streams; gather_predictions covers the rest).

    Returns the (H, W) uint8 predicted plane:
      out[y, x] = canvas[y + dy[b], x + dx[b]],  b = block of (y, x).

    Everything is full-width elementwise selects — no gathers and no
    transposes:
    * vertical pass: 33-way select over 48-row bands. Because the later
      horizontal shift can pull pixels from a horizontally adjacent block,
      three variants are built, each using the dy of the block s in
      {-1, 0, +1} columns to the right of the source column.
    * horizontal pass: 33-way select over lane-shifted variants, with a
      static per-column crossing mask picking which vertical variant is
      correct for each (within-block column, shift) pair.
    """
    h, w = canvas.shape
    gh, gw = h // 16, w // 16

    # vertical bands: band[r, k, x] = canvas[16r - 16 + k, x], k in [0, 48)
    padded = jnp.pad(canvas, ((16, 16), (0, 0)))
    band = jnp.concatenate(
        [padded[16 * j : 16 * j + h].reshape(gh, 16, w) for j in range(3)],
        axis=1,
    )  # (gh, 48, W)

    # dy of block (c + s) expanded to per-column masks (edge pads are never
    # selected: a variant s is only consulted when destination block c+s
    # exists and its window is in-plane)
    dy_pad = jnp.pad(dy, ((0, 0), (1, 1)))
    dyx = [
        jnp.repeat(dy_pad[:, 1 + s : 1 + s + gw], 16, axis=1)[:, None, :]
        for s in (-1, 0, 1)
    ]  # each (gh, 1, W)

    zero = jnp.zeros((gh, 16, w), dtype=canvas.dtype)
    v = [zero, zero, zero]
    for d in range(-16, 17):
        term = band[:, 16 + d : 32 + d, :]
        for s in range(3):
            v[s] = jnp.where(dyx[s] == d, term, v[s])

    # horizontal pass over (gh, 16, W) shapes; within-block column index
    # decides statically whether a shift crosses into a neighbor block
    p = np.arange(w) % 16
    dxx = jnp.repeat(dx, 16, axis=1)[:, None, :]  # (gh, 1, W)
    vp = [jnp.pad(x, ((0, 0), (0, 0), (16, 16))) for x in v]
    out = zero
    for d in range(-16, 17):
        sl = slice(16 + d, 16 + d + w)
        if d < 0:
            cross = jnp.asarray(p + d < 0)[None, None, :]
            pick = jnp.where(cross, vp[2][:, :, sl], vp[1][:, :, sl])
        elif d > 0:
            cross = jnp.asarray(p + d >= 16)[None, None, :]
            pick = jnp.where(cross, vp[0][:, :, sl], vp[1][:, :, sl])
        else:
            pick = vp[1][:, :, sl]
        out = jnp.where(dxx == d, pick, out)
    return out.reshape(h, w)


def motion_search(
    cur_blocks: jnp.ndarray,
    ref_plane: jnp.ndarray,
    by: jnp.ndarray,
    bx: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Four-step log search for every macroblock of a plane at once.

    Args:
      cur_blocks: (N, 16, 16) uint8 source macroblocks.
      ref_plane: (H, W) uint8 padded reference plane.
      by, bx: (N,) int32 top-left pixel origin of each block.

    Returns:
      (mv_x, mv_y, best_err, best_window): (N,) i32 motion components
      (window origin minus block origin, range -15..=15), (N,) i32 final SSD
      of the winning window, and (N, 16, 16) uint8 winning windows.
    """
    h, w = ref_plane.shape
    cur = cur_blocks.astype(jnp.int32)
    oy = by.astype(jnp.int32)
    ox = bx.astype(jnp.int32)
    cy = oy
    cx = ox

    # All search offsets satisfy |mv| <= 8+4+2+1 = 15, inside the 48x48
    # patches — every candidate window is two one-hot matmuls instead of
    # an XLA gather.
    patches = block_patches(ref_plane)

    best_err = None
    best_win = None
    for step in (8, 4, 2, 1):
        cand_x = cx[:, None] + _CAND_MX[None, :] * step  # (N, 9)
        cand_y = cy[:, None] + _CAND_MY[None, :] * step
        valid = (
            (cand_x >= 0)
            & (cand_x <= w - 16)
            & (cand_y >= 0)
            & (cand_y <= h - 16)
        )
        wins = jnp.stack(
            [
                onehot_windows(
                    patches, cand_y[:, k] - oy, cand_x[:, k] - ox
                )
                for k in range(9)
            ],
            axis=1,
        )  # (N, 9, 16, 16) i32 (exact pixel values)
        diff = cur[:, None, :, :] - wins.astype(jnp.int32)
        err = jnp.sum(diff * diff, axis=(-1, -2))  # (N, 9) i32, < 2^24
        prio = jnp.arange(9, dtype=jnp.int32)[None, :]
        score = jnp.where(valid, err * 16 + prio, _I32_MAX)
        best = jnp.argmin(score, axis=1)  # first min -> reference tie-break
        take = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
        cx = take(cand_x)
        cy = take(cand_y)
        best_err = take(err)
        best_win = jnp.take_along_axis(
            wins, best[:, None, None, None], axis=1
        )[:, 0].astype(jnp.uint8)

    mv_x = cx - ox
    mv_y = cy - oy
    return mv_x, mv_y, best_err, best_win


def gather_predictions(
    ref_plane: jnp.ndarray,
    by: jnp.ndarray,
    bx: jnp.ndarray,
    mv_y: jnp.ndarray,
    mv_x: jnp.ndarray,
) -> jnp.ndarray:
    """Motion-compensated prediction windows for decode (common.rs:254-261).

    Gather formulation — handles the format's full mv range (any window
    inside the padded plane). Returns (N, 16, 16) uint8 windows at
    (by + mv_y, bx + mv_x). predict_blocks_mxu is the one-hot-matmul
    twin for |mv| <= 16 (always true for encoder output).
    """
    y = by.astype(jnp.int32) + mv_y.astype(jnp.int32)
    x = bx.astype(jnp.int32) + mv_x.astype(jnp.int32)
    return jax.vmap(_gather_window, in_axes=(None, 0, 0))(ref_plane, y, x)


def predict_blocks_mxu(
    ref_plane: jnp.ndarray, mv_y: jnp.ndarray, mv_x: jnp.ndarray
) -> jnp.ndarray:
    """One-hot-matmul twin of gather_predictions for raster-order
    full-grid blocks.

    Valid for |mv| <= 16 (the reference encoder emits at most 15,
    enc.rs:448-449); bit-exact with the gather path on that domain.
    Returns (N, 16, 16) uint8.
    """
    patches = block_patches(ref_plane)
    win = onehot_windows(
        patches, mv_y.astype(jnp.int32), mv_x.astype(jnp.int32)
    )
    return win.astype(jnp.uint8)
