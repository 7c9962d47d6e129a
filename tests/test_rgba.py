"""Packed-RGBA output path (dataloader._rgba_xla + dataloader API).

The RGBA output must be byte-identical to the decode-to-RGB path (which is
itself oracle-tested) and to the host conversion of the scalar reference
decoder's planes: same float constants, op order, and Rust-`as u8`
saturation (reference lib.rs:378-391). PFV_STEP picks the step: the GPU
kernel in the Pallas interpreter ("interpret") or the XLA steps ("0")."""

from __future__ import annotations

import numpy as np
import pytest

from pfv_tpu.dataloader import (decode_video_rgb, decode_video_rgba,
                                rgba_view)
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame


def _clip(w, h, f):
    ys, us, vs = map(
        np.stack, zip(*[synth_yuv_frame(t, w, h) for t in range(f)])
    )
    return encode_video(ys, us, vs, 30, 3, keyframes=3)


@pytest.mark.parametrize(
    "w,h,step",
    [
        (128, 96, "interpret"),   # GPU step kernel
        (128, 96, "0"),           # XLA step
        (136, 90, "0"),           # odd geometry
        (136, 90, "interpret"),
    ],
)
def test_rgba_matches_rgb(w, h, step, monkeypatch):
    monkeypatch.setenv("PFV_STEP", step)
    data = _clip(w, h, 5)
    rgba = np.asarray(decode_video_rgba(data))
    rgb = np.asarray(decode_video_rgb(data))
    assert rgba.dtype == np.uint32 and rgba.shape == rgb.shape[:3]
    v4 = rgba_view(rgba)
    assert (v4[..., :3] == rgb).all()
    assert (v4[..., 3] == 255).all()


def test_rgba_gop_concurrent(monkeypatch):
    """The GOP-concurrent form (GOPs as the kernel's batch axis) and the
    per-frame form give the same RGBA."""
    from pfv_tpu import dataloader

    monkeypatch.setenv("PFV_STEP", "interpret")
    data = _clip(128, 96, 6)
    info, _ = dataloader._demux_packed_to_device(data, 0)
    assert info["gop_shape"] == (2, 3)
    a = np.asarray(decode_video_rgba(data))
    monkeypatch.setattr(dataloader, "_GOP_CONCURRENT_MAX_BLOCKS", 0)
    info, _ = dataloader._demux_packed_to_device(data, 0)
    assert info["gop_shape"] is None
    b = np.asarray(decode_video_rgba(data))
    assert (a == b).all()


def test_rgba_matches_reference(monkeypatch):
    """Kernel RGBA equals the host conversion of the scalar reference
    decoder's planes (the check chip_smoke.py makes on the card)."""
    from pfv_tpu.utils.timing import equal, reference_products

    monkeypatch.setenv("PFV_STEP", "interpret")
    data = _clip(256, 128, 8)
    assert equal(decode_video_rgba(data), reference_products(data)["rgba"])
