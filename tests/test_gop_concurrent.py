"""GOP-concurrent packed decode path (dataloader._gop_shape routing).

Small-geometry streams with a uniform keyframe interval decode as a
batch of per-GOP scans (vmapped XLA step, or the kernel's batch axis); output must be bit-identical to the
scalar reference decoder, including ragged last GOPs (pad frames)."""

from __future__ import annotations

import numpy as np
import pytest

from pfv_tpu import runtime
from pfv_tpu.dataloader import (
    _gop_shape, decode_video_checksums, decode_video_rgb, plane_checksums,
)
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame


def _encode(w, h, f, kf):
    ys, us, vs = map(
        np.stack, zip(*[synth_yuv_frame(t, w, h) for t in range(f)])
    )
    return encode_video(ys, us, vs, 30, 3, keyframes=kf)


def test_gop_shape_detection():
    ftype = np.array([1, 2, 2, 1, 2, 2, 1, 2], np.uint8)
    assert _gop_shape(ftype, 1000) == (3, 3)
    # ragged last GOP still uniform
    assert _gop_shape(np.array([1, 2, 2, 1], np.uint8), 1000) == (2, 3)
    # non-uniform interval -> None
    assert _gop_shape(np.array([1, 2, 1, 2, 2], np.uint8), 1000) is None
    # single GOP -> None
    assert _gop_shape(np.array([1, 2, 2], np.uint8), 1000) is None
    # big frames -> None
    assert _gop_shape(ftype, 100000) is None


@pytest.mark.parametrize("f,kf", [(8, 2), (7, 3)])  # even and ragged
def test_gop_concurrent_checksums(monkeypatch, f, kf):
    data = _encode(96, 64, f, kf)
    n, ry, ru, rv, _ = runtime.ref_decode(data)
    want = plane_checksums(ry, ru, rv)
    got = decode_video_checksums(data)
    assert got.shape == want.shape
    assert (got == want).all()


def test_gop_concurrent_rgb_matches_sequential(monkeypatch):
    from pfv_tpu import dataloader

    data = _encode(96, 64, 6, 2)
    a = np.asarray(decode_video_rgb(data))
    monkeypatch.setattr(dataloader, "_GOP_CONCURRENT_MAX_BLOCKS", 0)
    b = np.asarray(decode_video_rgb(data))
    assert a.shape == b.shape
    assert (a == b).all()


def test_gop_concurrent_with_step_kernel(monkeypatch):
    """GOP batch composed with the GPU step kernel (interpret on CPU)."""
    monkeypatch.setenv("PFV_STEP", "interpret")
    data = _encode(128, 96, 6, 2)
    n, ry, ru, rv, _ = runtime.ref_decode(data)
    want = plane_checksums(ry, ru, rv)
    got = decode_video_checksums(data)
    assert (got == want).all()
