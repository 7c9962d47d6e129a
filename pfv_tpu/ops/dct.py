"""Integer 8x8 DCT / inverse DCT (batched over arbitrary leading axes).

Implements the Bink-2-style integer butterfly transform used by the PFV codec
(reference: /root/reference/src/dct.rs:139-293) with bit-exact semantics:

* all arithmetic in wrapping int32 (two's-complement; XLA int32 wraps),
* divisions by 2/4/16 are *truncating* toward zero (Rust `/` semantics), NOT
  arithmetic shifts (reference dct.rs:206-214, 267-274 — SURVEY.md quirk Q3).

The transform is expressed as vectorized butterflies over a (..., 8) axis so a
whole frame's worth of 8x8 subblocks runs as one fused XLA computation in
place of the reference's per-block scalar loops under a rayon thread pool
(reference common.rs:373-378).
"""

from __future__ import annotations

import jax.numpy as jnp

FP_BITS = 8


def tdiv_pow2(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Truncating (round-toward-zero) signed division by 2**k for int32.

    Equivalent to Rust `x / (1<<k)`. Branch-free: add (2**k - 1) to negative
    values before the arithmetic right shift.
    """
    bias = (x >> 31) & ((1 << k) - 1)
    return (x + bias) >> k


def fdct8(x: jnp.ndarray) -> jnp.ndarray:
    """Forward 1-D transform along the last axis (length 8), int32 in/out.

    Mirrors reference dct.rs:176-239 (`DctMatrix8x8::fdct`) including the
    output permutation.
    """
    i0, i1, i2, i3, i4, i5, i6, i7 = (x[..., j] for j in range(8))

    # stage 1
    a0 = i0 + i7
    a1 = i1 + i6
    a2 = i2 + i5
    a3 = i3 + i4
    a4 = i0 - i7
    a5 = i1 - i6
    a6 = i2 - i5
    a7 = i3 - i4

    # even stage 2
    b0 = a0 + a3
    b1 = a1 + a2
    b2 = a0 - a3
    b3 = a1 - a2

    # even stage 3
    c0 = b0 + b1
    c1 = b0 - b1
    c2 = b2 + tdiv_pow2(b2, 2) + tdiv_pow2(b3, 1)
    c3 = tdiv_pow2(b2, 1) - b3 - tdiv_pow2(b3, 2)

    # odd stage 2
    b4 = tdiv_pow2(a7, 2) + a4 + tdiv_pow2(a4, 2) - tdiv_pow2(a4, 4)
    b7 = tdiv_pow2(a4, 2) - a7 - tdiv_pow2(a7, 2) + tdiv_pow2(a7, 4)
    b5 = a5 + a6 - tdiv_pow2(a6, 2) - tdiv_pow2(a6, 4)
    b6 = a6 - a5 + tdiv_pow2(a5, 2) + tdiv_pow2(a5, 4)

    # odd stage 3
    c4 = b4 + b5
    c5 = b4 - b5
    c6 = b6 + b7
    c7 = b6 - b7

    # odd stage 4
    d4 = c4
    d5 = c5 + c7
    d6 = c5 - c7
    d7 = c6

    # permute/output
    return jnp.stack([c0, d4, c2, d6, c1, d5, c3, d7], axis=-1)


def idct8(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse 1-D transform along the last axis (length 8), int32 in/out.

    Mirrors reference dct.rs:241-293 (`DctMatrix8x8::idct`).
    """
    return jnp.stack(idct8_lanes([x[..., j] for j in range(8)]), axis=-1)


def idct8_lanes(v: list) -> list:
    """idct8 over a list of 8 same-shape int32 arrays, elementwise.

    The butterflies of `idct8` with each of the 8 inputs held as its own
    array: the GPU step kernel keeps one coefficient slot per register
    vector and runs the transform lane-wise through this function.
    """
    c0, d4, c2, d6, c1, d5, c3, d7 = v

    # odd stage 4
    c4 = d4
    c5 = d5 + d6
    c7 = d5 - d6
    c6 = d7

    # odd stage 3
    b4 = c4 + c5
    b5 = c4 - c5
    b6 = c6 + c7
    b7 = c6 - c7

    # even stage 3
    b0 = c0 + c1
    b1 = c0 - c1
    b2 = c2 + tdiv_pow2(c2, 2) + tdiv_pow2(c3, 1)
    b3 = tdiv_pow2(c2, 1) - c3 - tdiv_pow2(c3, 2)

    # odd stage 2
    a4 = tdiv_pow2(b7, 2) + b4 + tdiv_pow2(b4, 2) - tdiv_pow2(b4, 4)
    a7 = tdiv_pow2(b4, 2) - b7 - tdiv_pow2(b7, 2) + tdiv_pow2(b7, 4)
    a5 = b5 - b6 + tdiv_pow2(b6, 2) + tdiv_pow2(b6, 4)
    a6 = b6 + b5 - tdiv_pow2(b5, 2) - tdiv_pow2(b5, 4)

    # even stage 2
    a0 = b0 + b2
    a1 = b1 + b3
    a2 = b1 - b3
    a3 = b0 - b2

    # stage 1
    return [a0 + a4, a1 + a5, a2 + a6, a3 + a7, a3 - a7, a2 - a6, a1 - a5,
            a0 - a4]


def fdct2d(m: jnp.ndarray) -> jnp.ndarray:
    """2-D forward DCT on (..., 8, 8) int32: rows pass, then columns pass.

    Pass order matters for bit-exactness (trunc-div is nonlinear); the
    reference transforms rows first, then columns (common.rs:294-295).
    """
    m = fdct8(m)
    m = jnp.swapaxes(fdct8(jnp.swapaxes(m, -1, -2)), -1, -2)
    return m


def idct2d(m: jnp.ndarray) -> jnp.ndarray:
    """2-D inverse DCT on (..., 8, 8) int32: columns pass, then rows pass.

    Reference order: dct_inverse_transform_columns then rows
    (common.rs:315-316).
    """
    m = jnp.swapaxes(idct8(jnp.swapaxes(m, -1, -2)), -1, -2)
    m = idct8(m)
    return m
