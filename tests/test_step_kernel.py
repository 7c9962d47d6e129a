"""GPU step-kernel (ops/pallas/step_kernel.py) bit-exactness tests.

The kernel runs in interpreter mode on the CPU test backend; every test
asserts exact pixel equality against the native scalar reference decoder
(and transitively the pure-XLA paths, which are oracle-tested elsewhere).
"""

from __future__ import annotations

import io

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


@pytest.fixture(autouse=True)
def _kernel(monkeypatch):
    """Every decode here takes the step kernel (Pallas interpreter), per
    frame (GOP-concurrent form off)."""
    from pfv_tpu import dataloader

    monkeypatch.setenv("PFV_STEP", "interpret")
    monkeypatch.setattr(dataloader, "_GOP_CONCURRENT_MAX_BLOCKS", 0)


def _assert_matches_reference(data):
    from pfv_tpu.dataloader import decode_video_yuv

    y, u, v = (np.asarray(p) for p in decode_video_yuv(data))
    n, ry, ru, rv, _ = runtime.ref_decode(data)
    assert y.shape == ry.shape
    assert (y == ry).all(), "Y mismatch"
    assert (u == ru).all(), "U mismatch"
    assert (v == rv).all(), "V mismatch"


@pytest.mark.parametrize(
    "w,h",
    [
        (128, 96),     # lane-aligned fused canvas
        (512, 384),    # the reference's speed-test geometry
        (136, 90),     # cw > luma width: dead filler columns in the Y region
        (112, 112),    # chroma region wider than luma region
    ],
)
def test_step_kernel_geometries(w, h):
    ys, us, vs = _clip(w, h, 6)
    data = encode_video(ys, us, vs, 30, 3, keyframes=3)
    _assert_matches_reference(data)


@pytest.mark.parametrize("quality", [0, 2, 7, 10])
def test_step_kernel_quality_sweep(quality):
    ys, us, vs = _clip(128, 96, 5)
    data = encode_video(ys, us, vs, 30, quality, keyframes=5)
    _assert_matches_reference(data)


def test_step_kernel_deep_gop():
    """Long P-chain: reconstruction drift would compound over 15 frames."""
    ys, us, vs = _clip(144, 128, 16)
    data = encode_video(ys, us, vs, 30, 4, keyframes=16)
    _assert_matches_reference(data)


def test_step_kernel_drop_frames():
    """Drop frames decode as repeat-previous; the step must not disturb
    the carried canvas (reference dec.rs:188-201, quirk Q8)."""
    from pfv_tpu import Encoder, VideoFrame

    w, h = 128, 96
    buf = io.BytesIO()
    enc = Encoder(buf, w, h, 30, 4)
    for t in range(5):
        y, u, v = synth_yuv_frame(t, w, h)
        f = VideoFrame(w, h, y, u, v)
        if t == 2:
            enc.encode_dropframe()
        (enc.encode_iframe if t == 0 else enc.encode_pframe)(f)
    enc.finish()
    _assert_matches_reference(buf.getvalue())
