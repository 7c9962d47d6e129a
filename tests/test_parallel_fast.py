"""Fast-path multi-device decode over the 8-device virtual mesh.

The sharded decode must run the SAME packed demux layout and step as the
single-device path — the GPU step kernel per shard inside shard_map, not
a separate dense demux + XLA scan. These tests force the kernel (in the
Pallas interpreter: PFV_STEP=interpret) with the per-frame form (GOP-
concurrent form off) and assert exact pixel equality against the native
scalar reference decoder, per stream / per frame.
"""

from __future__ import annotations

import numpy as np
import pytest

from pfv_tpu import runtime
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame

W, H, FPS, Q = 128, 48, 30, 3


def _clip(f, t0=0, w=W, h=H):
    ys, us, vs = map(
        np.stack, zip(*[synth_yuv_frame(t + t0, w, h) for t in range(f)])
    )
    return ys, us, vs


def _force_kernel(monkeypatch, step="interpret"):
    from pfv_tpu import dataloader

    monkeypatch.setenv("PFV_STEP", step)
    monkeypatch.setattr(dataloader, "_GOP_CONCURRENT_MAX_BLOCKS", 0)


def _ref_planes(data):
    _, ry, ru, rv, _ = runtime.ref_decode(data)
    return ry, ru, rv


def test_stream_batch_packed_units(monkeypatch):
    """8 streams, 8 devices: one step-kernel program per shard."""
    import jax

    from pfv_tpu.parallel.streams import (
        decode_stream_batch_packed, make_stream_mesh, stack_streams_packed)

    _force_kernel(monkeypatch)
    datas = [
        encode_video(*_clip(5, t0=9 * s), FPS, Q, keyframes=3)
        for s in range(8)
    ]
    info, stacked = stack_streams_packed(datas)
    assert info["decode_mode"] == "interpret", "kernel path not taken"
    assert info["gop_shape"] is None

    mesh = make_stream_mesh(8)
    (y, u, v), gmean = decode_stream_batch_packed(datas, mesh, want="yuv")
    assert len(y.sharding.device_set) == 8  # actually sharded
    y, u, v = map(np.asarray, (y, u, v))
    for s in range(8):
        ry, ru, rv = _ref_planes(datas[s])
        assert (y[s] == ry).all(), f"stream {s} luma"
        assert (u[s] == ru).all() and (v[s] == rv).all(), f"stream {s}"
    want_mean = y.astype(np.float64).mean()
    assert abs(float(gmean) - want_mean) < 0.5


def test_stream_batch_packed_two_per_device(monkeypatch):
    """8 streams on a 4-device mesh: static 2-stream loop per shard."""
    from pfv_tpu.parallel.streams import (
        decode_stream_batch_packed, make_stream_mesh)

    _force_kernel(monkeypatch)
    datas = [
        encode_video(*_clip(4, t0=5 * s), FPS, Q, keyframes=2)
        for s in range(8)
    ]
    mesh = make_stream_mesh(4)
    (y, u, v), _ = decode_stream_batch_packed(datas, mesh, want="yuv")
    y = np.asarray(y)
    for s in (0, 5, 7):
        ry, _, _ = _ref_planes(datas[s])
        assert (y[s] == ry).all(), f"stream {s}"


def test_skip_pframe_packet_is_copy():
    """The synthesized all-skip P packet must decode (in the independent
    scalar reference decoder) as a bit-exact copy of the previous frame."""
    import struct

    from pfv_tpu.parallel.gops import skip_pframe_packet

    data = encode_video(*_clip(3), FPS, Q, keyframes=8)
    eof = struct.pack("<BI", 0, 0)
    assert data.endswith(eof)
    padded = data[:-len(eof)] + skip_pframe_packet(W, H) * 2 + eof
    n, y, u, v, _ = runtime.ref_decode(padded)
    assert n == 5
    assert (y[3] == y[2]).all() and (y[4] == y[2]).all()
    assert (u[3] == u[2]).all() and (v[4] == v[2]).all()


def test_split_gop_runs_balanced():
    from pfv_tpu.parallel.gops import split_gop_runs

    # 11 frames, keyframe every 2 => GOPs of 2,2,2,2,2,1
    data = encode_video(*_clip(11), FPS, Q, keyframes=2)
    subs, counts = split_gop_runs(data, 4)
    assert len(subs) == 4 and sum(counts) == 11
    assert all(c >= 1 for c in counts)
    # every substream must open with an I-frame and be ref-decodable to
    # the SAME padded length (frame counts equalized with skip packets)
    lens = set()
    for sub, c in zip(subs, counts):
        n, y, _, _, _ = runtime.ref_decode(sub)
        lens.add(n)
        assert n >= c
    assert len(lens) == 1


def test_gops_packed_matches_reference(monkeypatch):
    """GOP runs of one stream sharded over 4 devices, decoded through the
    step kernel per shard, stitched back in frame order."""
    from pfv_tpu.parallel.gops import decode_video_gops_packed
    from pfv_tpu.parallel.streams import make_stream_mesh

    _force_kernel(monkeypatch)
    data = encode_video(*_clip(11), FPS, Q, keyframes=2)
    mesh = make_stream_mesh(4, axis="gops")
    y, u, v = decode_video_gops_packed(data, mesh=mesh, want="yuv")
    ry, ru, rv = _ref_planes(data)
    assert y.shape == ry.shape, (y.shape, ry.shape)
    assert (np.asarray(y) == ry).all()
    assert (np.asarray(u) == ru).all() and (np.asarray(v) == rv).all()


def test_gops_packed_rgb(monkeypatch):
    from pfv_tpu.parallel.gops import decode_video_gops_packed
    from pfv_tpu.parallel.streams import make_stream_mesh

    _force_kernel(monkeypatch)
    data = encode_video(*_clip(9, t0=4), FPS, Q, keyframes=2)
    mesh = make_stream_mesh(2, axis="gops")
    rgb = decode_video_gops_packed(data, mesh=mesh, want="rgb")
    assert rgb.shape == (9, H, W, 3)

    from pfv_tpu.dataloader import decode_video_rgb

    want = np.asarray(decode_video_rgb(data))
    assert (np.asarray(rgb) == want).all()


def test_stream_batch_packed_scatter_path(monkeypatch):
    """PFV_STEP=0: the XLA step shards the same way."""
    from pfv_tpu.parallel.streams import (
        decode_stream_batch_packed, make_stream_mesh, stack_streams_packed)

    _force_kernel(monkeypatch, step="0")
    datas = [
        encode_video(*_clip(4, t0=3 * s), FPS, Q, keyframes=2)
        for s in range(4)
    ]
    info, _ = stack_streams_packed(datas)
    assert info["decode_mode"] == "mxu"
    mesh = make_stream_mesh(4)
    (y, u, v), _ = decode_stream_batch_packed(datas, mesh, want="yuv")
    y = np.asarray(y)
    for s in range(4):
        ry, _, _ = _ref_planes(datas[s])
        assert (y[s] == ry).all(), f"stream {s}"
