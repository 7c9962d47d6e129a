"""GPU step kernel (ops/pallas/step_kernel.py) bit-exactness tests.

The kernel runs in the Pallas interpreter on the CPU test backend
(PFV_STEP=interpret): every decode test goes through the dataloader entry
points on the path a GPU takes (sparse demux -> device densify -> one
kernel launch per frame) and asserts exact pixel equality against the
native scalar reference decoder. The random-input tests compare one
kernel step with the XLA step on hand-built frames: intra, skipped and
coded inter blocks, |mv| = 16 at plane edges and the Y/U/V boundaries.
"""

from __future__ import annotations

import numpy as np
import pytest

from pfv_tpu import runtime
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame


def _clip(w, h, f, t0=0):
    ys, us, vs = map(
        np.stack, zip(*[synth_yuv_frame(t + t0, w, h) for t in range(f)])
    )
    return ys, us, vs


def _decode_kernel(data, monkeypatch):
    from pfv_tpu import dataloader

    monkeypatch.setenv("PFV_STEP", "interpret")
    info, _ = dataloader._demux_packed_to_device(data, 0)
    assert info["decode_mode"] == "interpret", "kernel path not taken"
    return tuple(np.asarray(p) for p in dataloader.decode_video_yuv(data))


def _assert_ref(data, got):
    n, ry, ru, rv, _ = runtime.ref_decode(data)
    y, u, v = got
    assert y.shape == ry.shape
    assert (y == ry).all() and (u == ru).all() and (v == rv).all()


@pytest.mark.parametrize(
    "w,h",
    [
        (256, 128),   # two kernel tiles per luma stripe
        (136, 90),    # width not a multiple of 16 or 128: dead filler
        (112, 112),   # chroma region (U | V) wider than the luma region
    ],
)
def test_units_matches_reference(w, h, monkeypatch):
    # keyframes=4 puts an I-frame mid-stream between P-frames
    ys, us, vs = _clip(w, h, 7)
    data = encode_video(ys, us, vs, 30, quality=2, keyframes=4)
    _assert_ref(data, _decode_kernel(data, monkeypatch))


def test_units_long_gop(monkeypatch):
    # single keyframe: every P-frame reads the canvas the kernel wrote
    ys, us, vs = _clip(128, 96, 6, t0=3)
    data = encode_video(ys, us, vs, 30, quality=4, keyframes=100)
    _assert_ref(data, _decode_kernel(data, monkeypatch))


def test_units_gop_batch(monkeypatch):
    # uniform keyframe interval on a small frame: the GOP-concurrent form
    # runs the GOPs as the kernel's batch axis (B > 1), ragged last GOP
    from pfv_tpu import dataloader

    ys, us, vs = _clip(96, 64, 7, t0=2)
    data = encode_video(ys, us, vs, 30, quality=2, keyframes=3)
    monkeypatch.setenv("PFV_STEP", "interpret")
    info, _ = dataloader._demux_packed_to_device(data, 0)
    assert info["gop_shape"] == (3, 3)
    _assert_ref(data, _decode_kernel(data, monkeypatch))


def test_units_dense_coefficients(monkeypatch):
    # quality=0 keeps many large coefficients (|v| > 127 spans several
    # units at one position, summed by the densify scatter)
    ys, us, vs = _clip(128, 64, 4, t0=7)
    data = encode_video(ys, us, vs, 30, quality=0, keyframes=4)
    _assert_ref(data, _decode_kernel(data, monkeypatch))


def _random_frame(rng, w, h, intra):
    """Random stream-layout inputs of one frame with every motion vector
    inside its own plane, half of them at the +-16 extremes."""
    from pfv_tpu.frame import pad16

    ly = (pad16(h), pad16(w))
    lc = (pad16(h // 2), pad16(w // 2))
    planes = [ly, lc, lc]
    mvs = []
    for ph, pw in planes:
        by, bx = np.divmod(np.arange((ph // 16) * (pw // 16)), pw // 16)
        by, bx = by * 16, bx * 16
        lo_y, hi_y = np.maximum(-16, -by), np.minimum(16, ph - 16 - by)
        lo_x, hi_x = np.maximum(-16, -bx), np.minimum(16, pw - 16 - bx)
        edge = rng.random(by.shape) < 0.5
        my = np.where(edge, np.where(rng.random(by.shape) < 0.5, lo_y, hi_y),
                      rng.integers(lo_y, hi_y + 1))
        mx = np.where(edge, np.where(rng.random(bx.shape) < 0.5, lo_x, hi_x),
                      rng.integers(lo_x, hi_x + 1))
        mvs.append((mx, my))
    mvx = np.concatenate([m[0] for m in mvs]).astype(np.int8)
    mvy = np.concatenate([m[1] for m in mvs]).astype(np.int8)
    nb = mvx.shape[0]
    coeffs = rng.integers(-300, 300, size=(nb, 256))
    coeffs[rng.random(coeffs.shape) < 0.85] = 0
    hc = (rng.random(nb) < 0.5).astype(np.uint8)
    ftype = 1 if intra else 2
    qidx = np.array([0, 1, 1] if intra else [2, 3, 3], np.int32)
    return coeffs.astype(np.int16), mvx, mvy, hc, ftype, qidx


@pytest.mark.parametrize("w,h,seed", [(64, 48, 0), (136, 90, 1),
                                      (48, 80, 2)])
def test_step_kernel_matches_xla_step(w, h, seed):
    """An I-frame, then two P-frames of random blocks: the kernel's
    canvases equal the XLA gather step's planes exactly."""
    import jax.numpy as jnp

    from pfv_tpu import dataloader
    from pfv_tpu.ops.quant import derive_q_tables

    rng = np.random.default_rng(seed)
    frames = [_random_frame(rng, w, h, intra=(i == 0)) for i in range(3)]
    args = tuple(np.stack([fr[k] for fr in frames]) for k in range(6))
    t = derive_q_tables(5)
    qt = np.stack([t["intra_l"], t["intra_c"], t["inter_l"], t["inter_c"]])
    want = dataloader.get_decoder(w, h, qt, "gather").decode_yuv(
        *map(jnp.asarray, args))
    got = dataloader.get_decoder(w, h, qt, "interpret").decode_yuv(
        *map(jnp.asarray, args))
    for g, x in zip(got, want):
        assert (np.asarray(g) == np.asarray(x)).all()
