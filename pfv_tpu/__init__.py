"""pfv_tpu — an accelerator rebuild of the PFV (Pretty Fast Video) codec.

Public API mirrors the reference crate (pfv_rs v0.2.2, codec v2.1.1):
`Encoder` (enc.rs), `Decoder` (dec.rs), `VideoFrame` (frame.rs). The dense
block math runs as batched JAX/Pallas programs on the device (a GPU step
kernel on the decode hot path); the serial entropy layer runs in a native
C++ extension.
"""

from pfv_tpu.dec import (
    DecodeError,
    Decoder,
    FormatError,
    StreamIOError,
    VersionError,
)
from pfv_tpu.enc import Encoder
from pfv_tpu.frame import VideoFrame

__version__ = "0.2.0"
CODEC_VERSION = 211

__all__ = [
    "Encoder",
    "Decoder",
    "DecodeError",
    "FormatError",
    "VersionError",
    "StreamIOError",
    "VideoFrame",
    "CODEC_VERSION",
    "encode_video",
    "decode_video_rgb",
    "decode_video_yuv",
    "VideoDataLoader",
]


def __getattr__(name):
    # lazy re-exports of the fast paths (avoid importing jax pipelines
    # before the user touches them)
    if name == "encode_video":
        from pfv_tpu.encoding import encode_video

        return encode_video
    if name in ("decode_video_rgb", "decode_video_yuv"):
        import pfv_tpu.dataloader as dl

        return getattr(dl, name)
    if name == "VideoDataLoader":
        from pfv_tpu.loader import VideoDataLoader

        return VideoDataLoader
    raise AttributeError(f"module 'pfv_tpu' has no attribute {name!r}")
