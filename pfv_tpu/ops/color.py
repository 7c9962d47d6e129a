"""YCbCr <-> RGB conversion and 4:2:0 chroma resampling.

The reference keeps RGB<->YUV only in its test helpers
(/root/reference/src/lib.rs:337-395, JPEG constants per Wikipedia "YCbCr");
the rebuild promotes it to library code so decoded frames can land in
device memory as RGB tensors (dataloader mode). Float math is float32 with the reference's
association order; the u8 casts reproduce Rust's saturating `as u8`
(truncate toward zero, clamp to 0..=255).

Chroma resampling is point sampling, not averaging (quirk Q11):
`reduce` takes every 2nd pixel (common.rs:523-536), `double` is
nearest-neighbor (common.rs:538-556).
"""

from __future__ import annotations

import jax.numpy as jnp


def _sat_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Rust `f32 as u8`: truncate toward zero, saturate to [0, 255]."""
    return jnp.clip(jnp.trunc(x), 0.0, 255.0).astype(jnp.uint8)


def rgb_to_yuv(rgb: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(..., 3) uint8 RGB -> (Y, U, V) uint8 planes (full resolution).

    Mirrors load_frame (lib.rs:340-346): JPEG YCbCr constants, f32 math.
    """
    r = rgb[..., 0].astype(jnp.float32)
    g = rgb[..., 1].astype(jnp.float32)
    b = rgb[..., 2].astype(jnp.float32)
    f = jnp.float32
    y = (f(0.299) * r) + (f(0.587) * g) + (f(0.114) * b)
    u = f(128.0) - (f(0.168736) * r) - (f(0.331264) * g) + (f(0.5) * b)
    v = f(128.0) + (f(0.5) * r) - (f(0.418688) * g) - (f(0.081312) * b)
    return _sat_u8(y), _sat_u8(u), _sat_u8(v)


def yuv_to_rgb(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Full-resolution uint8 Y/U/V planes -> (..., 3) uint8 RGB.

    Mirrors save_frame (lib.rs:378-391).
    """
    f = jnp.float32
    yf = y.astype(jnp.float32)
    uf = u.astype(jnp.float32) - f(128.0)
    vf = v.astype(jnp.float32) - f(128.0)
    r = yf + (f(1.402) * vf)
    g = yf - (f(0.344136) * uf) - (f(0.714136) * vf)
    b = yf + (f(1.772) * uf)
    return jnp.stack([_sat_u8(r), _sat_u8(g), _sat_u8(b)], axis=-1)


def rgb_to_yuv_np(rgb) -> tuple:
    """numpy twin of rgb_to_yuv (identical float32 math + saturating cast).

    Lets host-side tooling (corpus synthesis, tests) convert without touching
    the device.
    """
    import numpy as np

    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    f = np.float32
    y = (f(0.299) * r) + (f(0.587) * g) + (f(0.114) * b)
    u = f(128.0) - (f(0.168736) * r) - (f(0.331264) * g) + (f(0.5) * b)
    v = f(128.0) + (f(0.5) * r) - (f(0.418688) * g) - (f(0.081312) * b)

    def sat(x):
        return np.clip(np.trunc(x), 0.0, 255.0).astype(np.uint8)

    return sat(y), sat(u), sat(v)


def yuv_to_rgb_np(y, u, v):
    """numpy twin of yuv_to_rgb (identical float32 math + saturating cast):
    the host reference that device RGB output is checked against."""
    import numpy as np

    f = np.float32
    yf = y.astype(np.float32)
    uf = u.astype(np.float32) - f(128.0)
    vf = v.astype(np.float32) - f(128.0)
    r = yf + (f(1.402) * vf)
    g = yf - (f(0.344136) * uf) - (f(0.714136) * vf)
    b = yf + (f(1.772) * uf)

    def sat(x):
        return np.clip(np.trunc(x), 0.0, 255.0).astype(np.uint8)

    return np.stack([sat(r), sat(g), sat(b)], axis=-1)


def reduce_plane(plane: jnp.ndarray) -> jnp.ndarray:
    """Half-size by point sampling every 2nd pixel (common.rs:523-536)."""
    return plane[::2, ::2]


def double_plane(plane: jnp.ndarray) -> jnp.ndarray:
    """Double size by nearest-neighbor (common.rs:538-556)."""
    return jnp.repeat(jnp.repeat(plane, 2, axis=-2), 2, axis=-1)
