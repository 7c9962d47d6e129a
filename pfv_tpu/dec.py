"""PFV Decoder: public streaming API, mirroring the reference
(/root/reference/src/dec.rs:38-224).

Packet demux and entropy decode run on the host (C++), producing dense
coefficient tensors; everything below — dequantization, inverse DCT, motion
compensation, residual application — is one batched device program per plane.
The decoder is configured entirely by the bitstream: q-tables ride in the
header, per-frame indices select one per plane (dec.rs:96-111, 244-246).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Callable

import jax.numpy as jnp
import numpy as np

from pfv_tpu import runtime
from pfv_tpu.device import (
    iframe_decode_plane,
    origins_for,
    pframe_decode_plane,
)
from pfv_tpu.frame import VideoFrame, pad16

PFV_MAGIC = b"PFVIDEO\0"
PFV_VERSION = 211


class DecodeError(Exception):
    """Decode failure; subclasses mirror the reference taxonomy
    (dec.rs:30-35: FormatError / VersionError / IOError)."""


class FormatError(DecodeError):
    """Bad magic / malformed container (dec.rs:51)."""


class VersionError(DecodeError):
    """Codec version mismatch (dec.rs:58)."""


class StreamIOError(DecodeError, EOFError):
    """Truncated or unreadable stream, or a corrupt payload — the
    reference wraps these as DecodeError::IOError / io::Error from
    advance_frame. Also subclasses EOFError so pre-taxonomy callers that
    caught EOFError on mid-packet truncation keep working."""


class Decoder:
    """Streaming PFV decoder over a seekable binary reader.

    The container may start at any byte offset of the reader (the
    reference takes any `Read + Seek`, dec.rs:38); all seeks are relative
    to the position at construction time.
    """

    def __init__(self, reader: BinaryIO, num_threads: int = 0):
        del num_threads
        self._reader = reader
        self._header_start = reader.tell()

        magic = reader.read(8)
        if len(magic) < 8:
            raise StreamIOError("unexpected end of stream in header")
        if magic != PFV_MAGIC:
            raise FormatError("format error: bad magic")
        raw = reader.read(12)
        if len(raw) < 12:
            raise StreamIOError("unexpected end of stream in header")
        (version,) = struct.unpack("<I", raw[:4])
        if version != PFV_VERSION:
            raise VersionError(f"version error: {version} != {PFV_VERSION}")
        w, h, fps, nq = struct.unpack("<HHHH", raw[4:])
        self._width = w
        self._height = h
        self._framerate = fps
        qt_raw = reader.read(nq * 128)
        if len(qt_raw) < nq * 128:
            raise StreamIOError("unexpected end of stream in q-tables")
        qtables = np.frombuffer(qt_raw, dtype="<u2")
        qtables = qtables.astype(np.int32).reshape(nq, 64)
        self._qtables = [jnp.asarray(q) for q in qtables]
        self.qtables = qtables

        self._reset_pos = reader.tell()  # dec.rs:113-118
        self._delta_accum = 0.0
        self._eof = False

        # padded on-device framebuffer (dec.rs:123)
        self._ly = (pad16(h), pad16(w))
        self._lc = (pad16(h // 2), pad16(w // 2))
        self._fb = {
            "y": jnp.zeros(self._ly, dtype=jnp.uint8),
            "u": jnp.full(self._lc, 128, dtype=jnp.uint8),
            "v": jnp.full(self._lc, 128, dtype=jnp.uint8),
        }
        self._origins_y = origins_for(*self._ly)
        self._origins_c = origins_for(*self._lc)
        self._yb = (self._ly[0] // 16) * (self._ly[1] // 16)
        self._cb = (self._lc[0] // 16) * (self._lc[1] // 16)
        self._total_blocks = self._yb + 2 * self._cb

    # -- accessors (dec.rs:136-146) -------------------------------------------

    def width(self) -> int:
        return self._width

    def height(self) -> int:
        return self._height

    def framerate(self) -> int:
        return self._framerate

    # -- playback control ------------------------------------------------------

    def reset(self) -> None:
        """Rewind to the first packet (dec.rs:148-152)."""
        self._eof = False
        self._reader.seek(self._reset_pos)

    def advance_delta(
        self, delta: float, onvideo: Callable[[VideoFrame], None]
    ) -> bool:
        """Time-accumulator playback pump (dec.rs:154-167)."""
        self._delta_accum += delta
        delta_per_frame = 1.0 / self._framerate
        while self._delta_accum >= delta_per_frame:
            if not self.advance_frame(onvideo):
                return False
            self._delta_accum -= delta_per_frame
        return True

    def advance_frame(self, onvideo: Callable[[VideoFrame], None]) -> bool:
        """Decode the next frame; returns False at EOF (dec.rs:169-224).

        Drop frames (I-packet, zero payload) consume a frame slot without
        invoking the callback (quirk Q8). Unknown packet types are skipped.
        """
        if self._eof:
            return False

        while True:
            hdr = self._reader.read(5)
            if len(hdr) < 5:
                raise StreamIOError("unexpected end of stream")
            ptype, plen = struct.unpack("<BI", hdr)

            if ptype == 0:
                self._eof = True
                return False
            if ptype == 1 and plen > 0:
                self._decode_iframe(self._read_payload(plen))
                onvideo(self._emit())
                break
            if ptype == 2:
                self._decode_pframe(self._read_payload(plen))
                onvideo(self._emit())
                break
            if ptype == 1:  # drop frame
                break
            self._reader.seek(plen, 1)  # unknown packet: skip payload

        return True

    def _read_payload(self, plen: int) -> bytes:
        payload = self._reader.read(plen)
        if len(payload) < plen:
            raise StreamIOError("unexpected end of stream in packet payload")
        return payload

    def decode_all(self) -> list[VideoFrame]:
        """Decode every remaining frame via the fast whole-video path.

        Unlike advance_frame (one device round-trip per frame), this demuxes
        the whole stream in one native call and decodes all frames as a
        single device program, then fetches them in one batch. Must be
        called with the stream at the first packet (fresh decoder or after
        reset()) — P-frames reference preceding state, so a mid-stream bulk
        decode would be wrong. Leaves the stream at EOF.
        """
        from pfv_tpu.dataloader import decode_video_yuv

        if self._eof:
            return []
        pos = self._reader.tell()
        if pos != self._reset_pos:
            raise ValueError(
                "decode_all requires the stream at the first packet; "
                "call reset() first"
            )
        rest = self._reader.read()
        self._eof = True
        if not rest:
            return []
        # reconstitute a standalone stream: header + remaining packets
        # (the container may be embedded at any offset of the reader)
        self._reader.seek(self._header_start)
        header = self._reader.read(self._reset_pos - self._header_start)
        self._reader.seek(pos + len(rest))
        ys, us, vs = map(np.asarray, decode_video_yuv(header + rest))
        return [
            VideoFrame(self._width, self._height, ys[i], us[i], vs[i])
            for i in range(ys.shape[0])
        ]

    # -- internals --------------------------------------------------------------

    def _emit(self) -> VideoFrame:
        w, h = self._width, self._height
        cw, ch = w // 2, h // 2
        return VideoFrame(
            w,
            h,
            np.asarray(self._fb["y"])[:h, :w],
            np.asarray(self._fb["u"])[:ch, :cw],
            np.asarray(self._fb["v"])[:ch, :cw],
        )

    def _check_qidx(self, qidx) -> None:
        if any(int(q) >= len(self._qtables) for q in qidx):
            raise StreamIOError(
                f"corrupt payload: q-table index {list(qidx)} out of range "
                f"(header has {len(self._qtables)} tables)"
            )

    def _decode_iframe(self, payload: bytes) -> None:
        try:
            coeffs, qidx = runtime.decode_iframe_payload(
                payload, self._total_blocks
            )
        except ValueError as e:
            raise StreamIOError(str(e)) from e
        self._check_qidx(qidx)
        yb, cb = self._yb, self._cb
        parts = (
            ("y", coeffs[:yb], qidx[0]),
            ("u", coeffs[yb : yb + cb], qidx[1]),
            ("v", coeffs[yb + cb :], qidx[2]),
        )
        for name, c, qi in parts:
            self._fb[name] = iframe_decode_plane(
                jnp.asarray(c), self._qtables[qi], self._fb[name]
            )

    def _decode_pframe(self, payload: bytes) -> None:
        try:
            coeffs, mvx, mvy, has_coeff, qidx = runtime.decode_pframe_payload(
                payload, self._total_blocks
            )
            runtime.validate_motion(mvx, mvy, self._ly, self._lc)
        except ValueError as e:
            raise StreamIOError(str(e)) from e
        self._check_qidx(qidx)
        yb, cb = self._yb, self._cb
        parts = (
            ("y", slice(0, yb), qidx[0], self._origins_y),
            ("u", slice(yb, yb + cb), qidx[1], self._origins_c),
            ("v", slice(yb + cb, None), qidx[2], self._origins_c),
        )
        for name, sl, qi, (by, bx) in parts:
            self._fb[name] = pframe_decode_plane(
                jnp.asarray(coeffs[sl]),
                jnp.asarray(mvx[sl]),
                jnp.asarray(mvy[sl]),
                jnp.asarray(has_coeff[sl]),
                self._fb[name],
                self._qtables[qi],
                by,
                bx,
            )
