"""VideoDataLoader: pipelined multi-video decode-to-RGB for training input.

Dataloader mode: a background worker entropy-demuxes
and uploads video i+1 while the device decodes video i, so steady-state
throughput is max(host_demux, device_decode) instead of their sum. Decoded
frames are yielded as device-resident (F, H, W, 3) uint8 tensors, ready for
model ingestion; nothing is fetched back to the host.

Works for homogeneous batches (same geometry + q-tables reuse one compiled
program) and heterogeneous files (each geometry compiles once, cached).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp

from pfv_tpu.dataloader import _demux_packed_to_device, decode_packed


class VideoDataLoader:
    """Iterate .pfv byte streams (or file paths) -> device RGB tensors.

    Args:
      files: iterable of bytes or paths.
      num_threads: entropy-demux threads per video (0 = all cores).
      prefetch: how many demuxed+uploaded videos may wait ahead of decode.
    """

    def __init__(
        self,
        files: Iterable[bytes | str],
        num_threads: int = 0,
        prefetch: int = 2,
    ):
        self._files = files
        self._num_threads = num_threads
        self._prefetch = max(1, prefetch)

    def __iter__(self) -> Iterator[jnp.ndarray]:
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def worker():
            try:
                for f in self._files:
                    if stop.is_set():
                        return
                    data = open(f, "rb").read() if isinstance(f, str) else f
                    # demux on host + upload (H2D transfers release the GIL,
                    # overlapping with the consumer's device dispatches)
                    info, args = _demux_packed_to_device(data, self._num_threads)
                    q.put((info, args))
                q.put(None)
            except BaseException as e:  # surface errors to the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                # the same decoder, path and program as decode_video_rgb
                yield decode_packed(*item, "rgb")
        finally:
            stop.set()


def decode_many_rgb(datas: list[bytes], num_threads: int = 0) -> list[jnp.ndarray]:
    """Decode a list of videos through the pipelined loader; block on the
    last result so the full batch is resident when this returns."""
    out = list(VideoDataLoader(datas, num_threads))
    if out:
        jax.block_until_ready(out[-1])
    return out
