"""Timing and reference helpers shared by bench.py and chip_smoke.py.

Every decode timed here is checked against the independent scalar C++
decoder (`runtime.ref_decode`) at tolerance 0: the codec is integer-exact,
and the RGB products are the same float32 conversion run on the host
(`ops.color.yuv_to_rgb_np`).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np

PRODUCTS = ("yuv", "rgba", "rgb", "checksums")


def card_line() -> str:
    """The cards' `nvidia-smi --query-gpu=name,power.limit` line(s)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def median_ms(fn, reps: int) -> float:
    """Median wall milliseconds of `fn()` run to completion
    (jax.block_until_ready on its result), over `reps` runs."""
    import jax

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.repeat(np.repeat(c, 2, axis=-2), 2, axis=-1)[..., :h, :w]


def reference_products(data: bytes) -> dict:
    """Every decode product of `data`, from the scalar reference decoder's
    planes: {"yuv": (y, u, v), "rgb", "rgba", "checksums"}."""
    from pfv_tpu import runtime
    from pfv_tpu.dataloader import plane_checksums
    from pfv_tpu.ops.color import yuv_to_rgb_np

    _, y, u, v, _ = runtime.ref_decode(data)
    h, w = y.shape[1:]
    rgb = yuv_to_rgb_np(y, _upsample(u, h, w), _upsample(v, h, w))
    c = rgb.astype(np.uint32)
    rgba = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | np.uint32(
        0xFF000000)
    return {"yuv": (y, u, v), "rgb": rgb, "rgba": rgba,
            "checksums": plane_checksums(y, u, v)}


def equal(got, want) -> bool:
    """Exact equality of a (possibly tuple) device product with its
    host reference: same shape, same dtype, every element."""
    if isinstance(want, tuple):
        return len(got) == len(want) and all(
            equal(g, w) for g, w in zip(got, want))
    got = np.asarray(got)
    return (got.shape == want.shape and got.dtype == want.dtype
            and bool((got == want).all()))


def time_path(data: bytes, want: str, ref, reps: int,
              mode: str | None = None) -> dict:
    """Time one decode path of the dataloader entry points.

    mode forces the step ("kernel", "interpret", "mxu", "gather"; None =
    the default choice). Reports the first call (compile included), the
    median end-to-end call (demux + upload + decode) and the median
    device-only call (decode of already-uploaded units), all run to
    completion, and whether the output equals `ref` exactly (None when
    no ref is given)."""
    from pfv_tpu import dataloader as dl

    t = time.perf_counter()
    info, args = dl._demux_packed_to_device(data, 0, mode=mode)
    out = dl.decode_packed(info, args, want)
    ok = None if ref is None else equal(out, ref)
    first = (time.perf_counter() - t) * 1e3
    del out
    e2e = median_ms(lambda: dl.decode_packed(
        *dl._demux_packed_to_device(data, 0, mode=mode), want), reps)
    dev = median_ms(lambda: dl.decode_packed(info, args, want), reps)
    gs = info["gop_shape"]
    return {"mode": info["decode_mode"],
            "gop_shape": None if gs is None else list(gs), "ok": ok,
            "first_ms": first, "e2e_ms": e2e, "device_ms": dev}
