"""End-to-end codec tests: device pipeline vs oracle vs native scalar decoder.

The rebuild's analogue of the reference's integration tests
(lib.rs:241-335): encode a deterministic synthetic clip, assert the produced
.pfv is byte-identical to the independent oracle encoder's output, and that
all three decoders (JAX pipeline, python oracle, C++ scalar) agree
pixel-for-pixel.
"""

import io

import numpy as np
import pytest

from oracle import pfv_oracle as oracle

W, H, FPS, QUALITY = 96, 64, 30, 3
N_FRAMES = 8
KEYFRAME_INTERVAL = 4


@pytest.fixture(scope="module")
def clip():
    from pfv_tpu.utils.synth import synth_yuv_frame

    return [synth_yuv_frame(t, W, H) for t in range(N_FRAMES)]


@pytest.fixture(scope="module")
def encoded(clip):
    from pfv_tpu import Encoder, VideoFrame

    buf = io.BytesIO()
    enc = Encoder(buf, W, H, FPS, QUALITY)
    for t, (y, u, v) in enumerate(clip):
        frame = VideoFrame(W, H, y, u, v)
        if t % KEYFRAME_INTERVAL == 0:
            enc.encode_iframe(frame)
        else:
            enc.encode_pframe(frame)
    enc.finish()
    return buf.getvalue()


def test_bitstream_byte_identical_to_oracle(clip, encoded):
    oenc = oracle.OracleEncoder(W, H, FPS, QUALITY)
    for t, (y, u, v) in enumerate(clip):
        if t % KEYFRAME_INTERVAL == 0:
            oenc.encode_iframe(y, u, v)
        else:
            oenc.encode_pframe(y, u, v)
    want = oenc.finish()
    assert encoded == want


def test_decode_pipeline_matches_oracle(encoded):
    from pfv_tpu import Decoder

    dec = Decoder(io.BytesIO(encoded))
    assert dec.width() == W and dec.height() == H and dec.framerate() == FPS

    got = []
    while dec.advance_frame(lambda f: got.append((f.plane_y, f.plane_u, f.plane_v))):
        pass
    assert len(got) == N_FRAMES

    want = oracle.OracleDecoder(encoded).decode_all()
    assert len(want) == N_FRAMES
    for i, ((gy, gu, gv), (wy, wu, wv)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gy, wy, err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(gu, wu, err_msg=f"frame {i} U")
        np.testing.assert_array_equal(gv, wv, err_msg=f"frame {i} V")


def test_native_scalar_decoder_matches(encoded):
    from pfv_tpu import runtime

    n, y, u, v, info = runtime.ref_decode(encoded)
    assert n == N_FRAMES
    assert (info["width"], info["height"], info["framerate"]) == (W, H, FPS)

    want = oracle.OracleDecoder(encoded).decode_all()
    for i in range(n):
        np.testing.assert_array_equal(y[i], want[i][0], err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(u[i], want[i][1], err_msg=f"frame {i} U")
        np.testing.assert_array_equal(v[i], want[i][2], err_msg=f"frame {i} V")


def test_roundtrip_psnr(clip, encoded):
    """Decoded frames stay close to the source (quality sanity)."""
    from pfv_tpu import Decoder

    dec = Decoder(io.BytesIO(encoded))
    got = []
    while dec.advance_frame(lambda f: got.append(f.plane_y)):
        pass
    for (y, _, _), gy in zip(clip, got):
        mse = np.mean((y.astype(np.float64) - gy.astype(np.float64)) ** 2)
        psnr = 10 * np.log10(255.0**2 / max(mse, 1e-9))
        assert psnr > 26.0, psnr


def test_drop_frames_and_reset():
    from pfv_tpu import Decoder, Encoder, VideoFrame
    from pfv_tpu.utils.synth import synth_yuv_frame

    buf = io.BytesIO()
    enc = Encoder(buf, W, H, FPS, QUALITY)
    y, u, v = synth_yuv_frame(0, W, H)
    enc.encode_iframe(VideoFrame(W, H, y, u, v))
    enc.encode_dropframe()
    enc.encode_dropframe()
    y2, u2, v2 = synth_yuv_frame(1, W, H)
    enc.encode_pframe(VideoFrame(W, H, y2, u2, v2))
    enc.finish()
    data = buf.getvalue()

    dec = Decoder(io.BytesIO(data))
    emitted = []
    results = []
    for _ in range(4):
        results.append(dec.advance_frame(lambda f: emitted.append(f.plane_y.copy())))
    # 4 frame slots: I, drop, drop, P -> only 2 callbacks (quirk Q8)
    assert results == [True, True, True, True]
    assert len(emitted) == 2
    assert dec.advance_frame(lambda f: emitted.append(f.plane_y)) is False  # EOF
    assert dec.advance_frame(lambda f: None) is False  # stays EOF

    # reset rewinds to the first packet (dec.rs:148-152)
    dec.reset()
    emitted2 = []
    assert dec.advance_frame(lambda f: emitted2.append(f.plane_y.copy()))
    np.testing.assert_array_equal(emitted2[0], emitted[0])

    # the C++ scalar decoder agrees on drop-frame handling
    from pfv_tpu import runtime

    n, ry, _, _, _ = runtime.ref_decode(data)
    assert n == 2
    np.testing.assert_array_equal(ry[0], emitted[0])
    np.testing.assert_array_equal(ry[1], emitted[1])


def test_advance_delta_pacing():
    from pfv_tpu import Decoder, Encoder, VideoFrame
    from pfv_tpu.utils.synth import synth_yuv_frame

    buf = io.BytesIO()
    enc = Encoder(buf, W, H, 30, QUALITY)
    for t in range(3):
        y, u, v = synth_yuv_frame(t, W, H)
        if t == 0:
            enc.encode_iframe(VideoFrame(W, H, y, u, v))
        else:
            enc.encode_pframe(VideoFrame(W, H, y, u, v))
    enc.finish()

    dec = Decoder(io.BytesIO(buf.getvalue()))
    count = [0]
    cb = lambda f: count.__setitem__(0, count[0] + 1)
    assert dec.advance_delta(1.0 / 60.0, cb)  # half a frame: nothing yet
    assert count[0] == 0
    assert dec.advance_delta(1.0 / 60.0, cb)  # full frame accumulated
    assert count[0] == 1
    assert dec.advance_delta(2.0 / 30.0, cb)  # two frames
    assert count[0] == 3


def test_unknown_packet_skipped():
    import struct

    from pfv_tpu import Decoder, Encoder, VideoFrame
    from pfv_tpu.utils.synth import synth_yuv_frame

    buf = io.BytesIO()
    enc = Encoder(buf, W, H, FPS, QUALITY)
    y, u, v = synth_yuv_frame(0, W, H)
    # splice an unknown packet type (99) after the header
    enc.encode_iframe(VideoFrame(W, H, y, u, v))
    enc.finish()
    data = buf.getvalue()

    hdr_end = 20 + 4 * 128
    junk = struct.pack("<BI", 99, 7) + b"JUNKDAT"
    spliced = data[:hdr_end] + junk + data[hdr_end:]

    dec = Decoder(io.BytesIO(spliced))
    emitted = []
    assert dec.advance_frame(lambda f: emitted.append(f))
    assert len(emitted) == 1

    from pfv_tpu import runtime

    n, _, _, _, _ = runtime.ref_decode(spliced)
    assert n == 1


def test_quality_sweep_rate_distortion(clip):
    """Coarser quality -> smaller files; files decode consistently
    (BASELINE.json config 4)."""
    from pfv_tpu import Decoder, Encoder, VideoFrame

    sizes = {}
    psnrs = {}
    for quality in (0, 4, 8, 10):
        buf = io.BytesIO()
        enc = Encoder(buf, W, H, FPS, quality)
        for t, (y, u, v) in enumerate(clip[:4]):
            f = VideoFrame(W, H, y, u, v)
            (enc.encode_iframe if t == 0 else enc.encode_pframe)(f)
        enc.finish()
        data = buf.getvalue()
        sizes[quality] = len(data)

        dec = Decoder(io.BytesIO(data))
        got = []
        while dec.advance_frame(lambda f: got.append(f.plane_y)):
            pass
        mse = np.mean(
            [
                ((c[0].astype(np.float64) - g.astype(np.float64)) ** 2).mean()
                for c, g in zip(clip, got)
            ]
        )
        psnrs[quality] = 10 * np.log10(255.0**2 / max(mse, 1e-9))

    assert sizes[0] > sizes[4] > sizes[8] >= sizes[10]
    assert psnrs[0] > psnrs[10]


def test_encoder_stats():
    from pfv_tpu import Encoder, VideoFrame
    from pfv_tpu.utils.synth import synth_yuv_frame

    buf = io.BytesIO()
    enc = Encoder(buf, W, H, FPS, 5)
    enc.collect_psnr = True
    for t in range(3):
        y, u, v = synth_yuv_frame(t, W, H)
        f = VideoFrame(W, H, y, u, v)
        (enc.encode_iframe if t == 0 else enc.encode_pframe)(f)
    enc.finish()

    assert [s["type"] for s in enc.stats] == ["I", "P", "P"]
    assert all(s["payload_bytes"] > 19 for s in enc.stats)
    assert enc.stats[0]["skip_pct"] == 0.0
    assert 0.0 <= enc.stats[1]["skip_pct"] <= 100.0
    assert all(20.0 < s["psnr_y"] < 60.0 for s in enc.stats)


def test_decode_all_fast_path(encoded):
    from pfv_tpu import Decoder

    dec = Decoder(io.BytesIO(encoded))
    frames = dec.decode_all()
    assert len(frames) == N_FRAMES
    assert dec.advance_frame(lambda f: None) is False  # at EOF

    # matches the streaming path exactly
    dec.reset()
    got = []
    while dec.advance_frame(lambda f: got.append(f)):
        pass
    for a, b in zip(frames, got):
        np.testing.assert_array_equal(a.plane_y, b.plane_y)
        np.testing.assert_array_equal(a.plane_u, b.plane_u)
        np.testing.assert_array_equal(a.plane_v, b.plane_v)

    # mid-stream bulk decode is refused (P-frames need preceding state)
    dec.reset()
    dec.advance_frame(lambda f: None)
    with pytest.raises(ValueError):
        dec.decode_all()
    # but works again after reset
    dec.reset()
    assert len(dec.decode_all()) == N_FRAMES


def test_odd_dimensions_rejected():
    from pfv_tpu import Encoder

    with pytest.raises(ValueError):
        Encoder(io.BytesIO(), 97, 64, 30, 5)
    with pytest.raises(ValueError):
        Encoder(io.BytesIO(), 96, 63, 30, 5)


def test_foreign_multi_qtable_stream(encoded):
    """The decoder is configured by the bitstream: a header carrying extra
    q-tables (more than the encoder's 4) must decode identically."""
    import struct

    from pfv_tpu import Decoder, runtime
    from pfv_tpu.dataloader import decode_video_yuv

    nq = 6
    extra = np.arange(1, 129, 2, dtype="<u2").tobytes()  # 2 extra tables
    hdr = encoded[:18] + struct.pack("<H", nq) + encoded[20 : 20 + 4 * 128] \
        + extra + extra[:128]
    foreign = hdr + encoded[20 + 4 * 128 :]

    dec = Decoder(io.BytesIO(foreign))
    assert dec.qtables.shape == (nq, 64)
    got = []
    while dec.advance_frame(lambda f: got.append(f.plane_y)):
        pass

    n, ry, *_ = runtime.ref_decode(foreign)
    assert n == len(got) == N_FRAMES
    for i in range(n):
        np.testing.assert_array_equal(got[i], ry[i])

    ys, _, _ = decode_video_yuv(foreign)
    np.testing.assert_array_equal(np.asarray(ys), np.stack(got))


def test_300_qtable_stream(encoded):
    """The format carries a u16 table count; a legal 300-table stream must
    parse and decode (the reference keeps them all, dec.rs:96-111)."""
    import struct

    from pfv_tpu import Decoder, runtime
    from pfv_tpu.dataloader import decode_video_yuv

    nq = 300
    base = encoded[20 : 20 + 4 * 128]
    filler = np.full(64, 7, dtype="<u2").tobytes()
    hdr = encoded[:18] + struct.pack("<H", nq) + base + filler * (nq - 4)
    stream = hdr + encoded[20 + 4 * 128 :]

    info, off = runtime.parse_header(stream)
    assert info["qtables"].shape == (nq, 64)
    assert off == 20 + nq * 128

    dec = Decoder(io.BytesIO(stream))
    got = []
    while dec.advance_frame(lambda f: got.append(f.plane_y)):
        pass
    n, ry, *_ = runtime.ref_decode(stream)
    assert n == len(got) == N_FRAMES
    np.testing.assert_array_equal(np.stack(got), ry)
    ys, _, _ = decode_video_yuv(stream)
    np.testing.assert_array_equal(np.asarray(ys), ry)


def test_stream_embedded_at_offset(encoded):
    """The decoder must work at any position of a seekable reader
    (dec.rs:38-118) — including the decode_all fast path."""
    from pfv_tpu import Decoder

    junk = b"\x13" * 777
    reader = io.BytesIO(junk + encoded)
    reader.seek(len(junk))
    dec = Decoder(reader)
    frames = dec.decode_all()
    assert len(frames) == N_FRAMES

    reader.seek(len(junk))
    dec2 = Decoder(reader)
    got = []
    while dec2.advance_frame(lambda f: got.append(f)):
        pass
    assert len(got) == N_FRAMES
    for a, b in zip(frames, got):
        np.testing.assert_array_equal(a.plane_y, b.plane_y)

    # reset() returns to the first packet of the embedded stream
    dec2.reset()
    assert dec2.advance_frame(lambda f: None) is True


def test_error_taxonomy(encoded):
    """DecodeError subtypes mirror dec.rs:30-35."""
    from pfv_tpu import (
        DecodeError,
        Decoder,
        FormatError,
        StreamIOError,
        VersionError,
    )

    with pytest.raises(FormatError):
        Decoder(io.BytesIO(b"NOTPFV\0\0" + encoded[8:]))
    with pytest.raises(VersionError):
        Decoder(io.BytesIO(encoded[:8] + b"\xff\x00\x00\x00" + encoded[12:]))
    with pytest.raises(StreamIOError):
        Decoder(io.BytesIO(encoded[:10]))  # truncated header
    assert issubclass(FormatError, DecodeError)
    assert issubclass(VersionError, DecodeError)
    assert issubclass(StreamIOError, DecodeError)
    # mid-packet truncation raises the IO subtype (also an EOFError for
    # backwards compatibility)
    dec = Decoder(io.BytesIO(encoded[:-30]))
    with pytest.raises(StreamIOError):
        while dec.advance_frame(lambda f: None):
            pass
    assert issubclass(StreamIOError, EOFError)
