"""PFV Encoder: public streaming API, mirroring the reference
(/root/reference/src/enc.rs:37-188).

Per frame: planes are padded and encoded on the device as one batched program
per plane (DCT/quantization, motion search, residuals, in-loop
reconstruction); the quantized coefficient tensors come back to the host
where the native C++ entropy coder (RLE + per-frame Huffman) muxes the
packet. The reconstructed previous frame stays on device between frames.

Quality semantics are inverted (quirk Q4): 0 = finest, 10 = coarsest.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import jax.numpy as jnp
import numpy as np

from pfv_tpu import runtime
from pfv_tpu.device import (
    iframe_encode_plane,
    origins_for,
    pad_plane_host,
    pframe_encode_plane,
)
from pfv_tpu.frame import VideoFrame, pad16
from pfv_tpu.ops.quant import derive_q_tables

PFV_MAGIC = b"PFVIDEO\0"
PFV_VERSION = 211


class Encoder:
    """Streaming PFV encoder.

    Mirrors pfv_rs::enc::Encoder::new (enc.rs:37-73): writes the container
    header on construction; `num_threads` is accepted for API parity but
    ignored (macroblock parallelism is a single batched device launch).
    """

    def __init__(
        self,
        writer: BinaryIO,
        width: int,
        height: int,
        framerate: int,
        quality: int = 5,
        num_threads: int = 0,
    ):
        del num_threads
        if not 0 <= quality <= 10:
            raise ValueError("quality must be in 0..=10")
        if width % 2 or height % 2:
            raise ValueError("width and height must be even (4:2:0 chroma)")
        self.width = width
        self.height = height
        self.framerate = framerate
        self._writer = writer
        self._finished = False
        # per-frame observability (SURVEY.md §5: bits/frame, skip-block %,
        # optional PSNR vs source) — the reference has no metrics at all
        self.collect_psnr = False
        self.stats: list[dict] = []

        px_err = np.float32(quality) * np.float32(1.5)  # enc.rs:41
        # skip threshold: px_err^2 * 256 in f32 (common.rs:209)
        self._min_err = jnp.float32(px_err * px_err * np.float32(256.0))

        t = derive_q_tables(quality)
        self._qt = {k: jnp.asarray(v) for k, v in t.items()}
        self._qt_host = t

        # padded plane shapes (frame.rs:28-49)
        self._ly = (pad16(height), pad16(width))
        self._lc = (pad16(height // 2), pad16(width // 2))
        self._origins_y = origins_for(*self._ly)
        self._origins_c = origins_for(*self._lc)

        # reconstructed previous frame, on device (enc.rs:16, 95-97)
        self._prev = {
            "y": jnp.zeros(self._ly, dtype=jnp.uint8),
            "u": jnp.full(self._lc, 128, dtype=jnp.uint8),
            "v": jnp.full(self._lc, 128, dtype=jnp.uint8),
        }

        self._write_header()

    # -- container ----------------------------------------------------------

    def _write_header(self) -> None:
        """Header: magic, version, dims, fps, 4 q-tables (enc.rs:190-219)."""
        w = self._writer
        w.write(PFV_MAGIC)
        w.write(struct.pack("<IHHHH", PFV_VERSION, self.width, self.height,
                            self.framerate, 4))
        for key in ("intra_l", "intra_c", "inter_l", "inter_c"):
            w.write(self._qt_host[key].astype("<u2").tobytes())

    def _write_packet(self, ptype: int, payload: bytes) -> None:
        self._writer.write(struct.pack("<BI", ptype, len(payload)))
        self._writer.write(payload)

    # -- frame encoding ------------------------------------------------------

    def _check_frame(self, frame: VideoFrame) -> None:
        assert frame.width == self.width and frame.height == self.height
        assert frame.plane_y.shape == (self.height, self.width)
        assert frame.plane_u.shape == (self.height // 2, self.width // 2)
        assert frame.plane_v.shape == (self.height // 2, self.width // 2)
        assert not self._finished

    def _psnr(self, frame: VideoFrame) -> float | None:
        if not self.collect_psnr:
            return None
        from pfv_tpu.device import plane_mse

        h, w = self.height, self.width
        src = pad_plane_host(np.asarray(frame.plane_y), *self._ly, 0)
        mse = float(plane_mse(self._prev["y"][:h, :w], src[:h, :w]))
        return 10.0 * float(np.log10(255.0**2 / max(mse, 1e-9)))

    def encode_iframe(self, frame: VideoFrame) -> None:
        """Intra-encode a frame (enc.rs:75-123), q-table indices (0, 1, 1)."""
        self._check_frame(frame)
        coeff_parts = []
        for name, plane, q, clear, shape in (
            ("y", frame.plane_y, self._qt["intra_l"], 0, self._ly),
            ("u", frame.plane_u, self._qt["intra_c"], 128, self._lc),
            ("v", frame.plane_v, self._qt["intra_c"], 128, self._lc),
        ):
            padded = pad_plane_host(np.asarray(plane), *shape, clear)
            coeffs, recon = iframe_encode_plane(padded, q)
            self._prev[name] = recon
            coeff_parts.append(np.asarray(coeffs))
        all_coeffs = np.concatenate(coeff_parts, axis=0)
        payload = runtime.encode_iframe_payload(all_coeffs, (0, 1, 1))
        self._write_packet(1, payload)
        self.stats.append({
            "type": "I", "payload_bytes": len(payload), "skip_pct": 0.0,
            "psnr_y": self._psnr(frame),
        })

    def encode_pframe(self, frame: VideoFrame) -> None:
        """Inter-encode a frame (enc.rs:125-173), q-table indices (2, 3, 3)."""
        self._check_frame(frame)
        coeff_parts, mvx_parts, mvy_parts, hc_parts = [], [], [], []
        new_prev = {}
        for name, plane, q, clear, shape, origins in (
            ("y", frame.plane_y, self._qt["inter_l"], 0, self._ly, self._origins_y),
            ("u", frame.plane_u, self._qt["inter_c"], 128, self._lc, self._origins_c),
            ("v", frame.plane_v, self._qt["inter_c"], 128, self._lc, self._origins_c),
        ):
            padded = pad_plane_host(np.asarray(plane), *shape, clear)
            by, bx = origins
            coeffs, mvx, mvy, has_coeff, recon = pframe_encode_plane(
                padded, self._prev[name], q, self._min_err, by, bx
            )
            new_prev[name] = recon
            coeff_parts.append(np.asarray(coeffs))
            mvx_parts.append(np.asarray(mvx))
            mvy_parts.append(np.asarray(mvy))
            hc_parts.append(np.asarray(has_coeff))
        # prev_frame is replaced only after all planes encoded against it
        self._prev.update(new_prev)
        hc_all = np.concatenate(hc_parts)
        payload = runtime.encode_pframe_payload(
            np.concatenate(coeff_parts, axis=0),
            np.concatenate(mvx_parts),
            np.concatenate(mvy_parts),
            hc_all.astype(np.uint8),
            (2, 3, 3),
        )
        self._write_packet(2, payload)
        self.stats.append({
            "type": "P", "payload_bytes": len(payload),
            "skip_pct": round(100.0 * float((~hc_all).mean()), 2),
            "psnr_y": self._psnr(frame),
        })

    def encode_dropframe(self) -> None:
        """A zero-length I-frame packet (enc.rs:175-180, quirk Q8).

        Does not update the previous-frame state.
        """
        assert not self._finished
        self._write_packet(1, b"")

    def finish(self) -> None:
        """Write the EOF packet (enc.rs:182-188)."""
        assert not self._finished
        self._finished = True
        self._write_packet(0, b"")

    # Drop-equivalent auto-finish (enc.rs:28-34)
    def __enter__(self) -> "Encoder":
        return self

    def __exit__(self, *exc) -> None:
        if not self._finished:
            self.finish()

    def __del__(self):
        try:
            if not self._finished and not self._writer.closed:
                self.finish()
        except Exception:
            pass
