#!/usr/bin/env python3
"""Smoke test of the PFV codec on a GPU, through the user entry points.

    python chip_smoke.py           # one GPU: every single-device phase
    python chip_smoke.py --multi   # four GPUs: the multi-device path only

Single-device phases, on the three committed corpora at full size
(.bench_cache/corpus_*.pfv: 1080p, 1080p pan, 512x384):
  compile   compile time and memory analysis of the 1080p decode program;
  decode    decode_video_{yuv,rgba,rgb,checksums}: ms, frames/s, the path
            taken and peak device memory, each product bit-exact against
            the scalar C++ reference decoder (runtime.ref_decode);
  steps     the GPU step kernel against both XLA steps (band-select "mxu"
            and "gather"), end to end and device-only, plus the
            GOP-concurrent form on and off for the 512x384 corpus;
  loader    VideoDataLoader over all corpora, bit-exact;
  stream    the streaming Decoder.advance_frame, bit-exact;
  encode    a 1080p synthetic clip encoded on the GPU, byte-identical to
            the same encode on the host CPU, PSNR > 30 dB.

--multi: stream-parallel decode of four distinct 1080p clips (the GOPs of
the two 1080p corpora), GOP-sharded decode of one 1080p clip with four
GOPs, and GOP-sharded encode, each against its single-device result and
the scalar reference decoder.

Prints the card's name and power limit, one line per check, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, without that
line, when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORPORA = {
    "1080p": "corpus_1920x1080_q2_120f.pfv",
    "1080p_pan": "corpus_1920x1080_q2_120f_pan.pfv",
    "sd": "corpus_512x384_q2_161f.pfv",
}
STEP_MODES = ("kernel", "mxu", "gather")

_failed: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool) -> None:
    log(f"  [{'PASS' if ok else 'FAIL'}] {name}")
    if not ok:
        _failed.append(name)


def load_corpus(name: str) -> bytes:
    with open(os.path.join(HERE, ".bench_cache", CORPORA[name]), "rb") as f:
        return f.read()


def phase_compile(data: bytes) -> None:
    """Compile time and memory analysis of the decode-to-YUV program."""
    from pfv_tpu import dataloader as dl

    info, args = dl._demux_packed_to_device(data, 0)
    dec = dl.get_decoder(info["width"], info["height"], info["qtables"],
                         info["decode_mode"])
    t = time.perf_counter()
    compiled = dec.decode_yuv_packed.lower(*args).compile()
    dt = time.perf_counter() - t
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    mem = {k: getattr(ma, k, None) for k in fields}
    log(f"compile {info['width']}x{info['height']} "
        f"mode={info['decode_mode']}: {dt:.3f} s, memory_analysis {mem}")


def phase_decode(name: str, data: bytes, ref: dict, reps: int) -> None:
    """Every dataloader product: timing, path, peak memory, bit-exact."""
    import jax

    from pfv_tpu.utils.timing import PRODUCTS, time_path

    nf = ref["yuv"][0].shape[0]
    for want in PRODUCTS:
        r = time_path(data, want, ref[want], reps)
        peak = (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")
        log(f"decode {name} {want}: e2e {r['e2e_ms']:.3f} ms "
            f"({nf / r['e2e_ms'] * 1e3:.1f} frames/s), device "
            f"{r['device_ms']:.3f} ms ({nf / r['device_ms'] * 1e3:.1f} "
            f"frames/s), first {r['first_ms']:.1f} ms, path "
            f"{r['mode']} gop_shape={r['gop_shape']}, "
            f"peak_bytes_in_use {peak}")
        check(f"{name} {want} == ref_decode", r["ok"])


def compare_steps(data: bytes, ref_yuv, reps: int,
                  modes=STEP_MODES) -> dict:
    """Decode-to-YUV through each step in `modes`: {mode: time_path
    result}. Every output must equal the reference."""
    from pfv_tpu.utils.timing import time_path

    return {m: time_path(data, "yuv", ref_yuv, reps, mode=m) for m in modes}


def compare_gop_form(data: bytes, ref_yuv, reps: int) -> dict:
    """The default path with the GOP-concurrent form allowed and
    forbidden: {"on": ..., "off": ...}."""
    from pfv_tpu import dataloader as dl
    from pfv_tpu.utils.timing import time_path

    out = {"on": time_path(data, "yuv", ref_yuv, reps)}
    saved = dl._GOP_CONCURRENT_MAX_BLOCKS
    dl._GOP_CONCURRENT_MAX_BLOCKS = 0
    try:
        out["off"] = time_path(data, "yuv", ref_yuv, reps)
    finally:
        dl._GOP_CONCURRENT_MAX_BLOCKS = saved
    return out


def _report(label: str, results: dict) -> None:
    for k, r in results.items():
        log(f"{label} {k}: e2e {r['e2e_ms']:.3f} ms, device "
            f"{r['device_ms']:.3f} ms, first {r['first_ms']:.1f} ms, "
            f"path {r['mode']} gop_shape={r['gop_shape']}")
        check(f"{label} {k} == ref_decode", r["ok"])


def phase_steps(name: str, data: bytes, ref: dict, reps: int) -> None:
    res = compare_steps(data, ref["yuv"], reps)
    _report(f"steps {name}", res)
    best = min(res, key=lambda m: res[m]["e2e_ms"])
    log(f"steps {name}: fastest end to end = {best}")
    if name == "sd":
        _report(f"gop-form {name}", compare_gop_form(data, ref["yuv"], reps))


def phase_loader(datas: dict, refs_rgb: dict) -> None:
    import jax

    from pfv_tpu.loader import VideoDataLoader
    from pfv_tpu.utils.timing import equal

    t = time.perf_counter()
    outs = list(VideoDataLoader(list(datas.values())))
    jax.block_until_ready(outs)
    log(f"loader {len(outs)} videos: {time.perf_counter() - t:.3f} s")
    for name, out in zip(datas, outs):
        check(f"VideoDataLoader {name} == ref_decode", equal(out,
                                                             refs_rgb[name]))


def phase_stream(name: str, data: bytes, ref_yuv) -> None:
    from pfv_tpu import Decoder

    frames = []
    t = time.perf_counter()
    dec = Decoder(io.BytesIO(data))
    while dec.advance_frame(frames.append):
        pass
    dt = time.perf_counter() - t
    y, u, v = ref_yuv
    ok = len(frames) == y.shape[0] and all(
        (f.plane_y == y[i]).all() and (f.plane_u == u[i]).all()
        and (f.plane_v == v[i]).all() for i, f in enumerate(frames))
    log(f"stream {name}: {len(frames)} frames in {dt:.3f} s "
        f"({len(frames) / dt:.1f} frames/s)")
    check(f"Decoder.advance_frame {name} == ref_decode", ok)


def synth_clip(n: int, w: int, h: int, t0: int = 0):
    from pfv_tpu.utils.synth import synth_yuv_frame

    return tuple(map(np.stack, zip(*[synth_yuv_frame(t0 + t, w, h)
                                     for t in range(n)])))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase_encode(frames: int = 30, w: int = 1920, h: int = 1080,
                 quality: int = 2, keyframes: int = 15) -> None:
    import jax

    from pfv_tpu import runtime
    from pfv_tpu.encoding import encode_video

    ys, us, vs = synth_clip(frames, w, h)
    t = time.perf_counter()
    gpu = encode_video(ys, us, vs, 30, quality, keyframes)
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    gpu2 = encode_video(ys, us, vs, 30, quality, keyframes)
    t_gpu2 = time.perf_counter() - t
    t = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = encode_video(ys, us, vs, 30, quality, keyframes)
    t_cpu = time.perf_counter() - t
    _, ry, _, _, _ = runtime.ref_decode(gpu)
    p = psnr(ry, ys)
    # the second call guesses a new compaction cap from the first one's
    # nonzero count, so it may compile again (encoding._make_encoder)
    log(f"encode {w}x{h} x{frames}: gpu first {t_gpu:.3f} s, second "
        f"{t_gpu2:.3f} s ({frames / t_gpu2:.2f} frames/s), cpu "
        f"{t_cpu:.3f} s, {len(gpu)} bytes, luma PSNR {p:.2f} dB")
    check("encode gpu == encode gpu (deterministic)", gpu == gpu2)
    check("encode gpu == encode cpu (byte-identical)", gpu == cpu)
    check("encode PSNR > 30 dB", p > 30)


def run_single(reps: int) -> None:
    names = list(CORPORA)
    datas = {n: load_corpus(n) for n in names}
    phase_compile(datas["1080p"])
    refs_rgb = {}
    for name in names:
        from pfv_tpu.utils.timing import reference_products

        ref = reference_products(datas[name])
        phase_decode(name, datas[name], ref, reps)
        phase_steps(name, datas[name], ref, reps)
        phase_stream(name, datas[name], ref["yuv"])
        refs_rgb[name] = ref["rgb"]
        del ref
    phase_loader(datas, refs_rgb)
    del refs_rgb
    phase_encode()


def _on_own_devices(arr, n: int) -> bool:
    devs = [s.device for s in arr.addressable_shards]
    return len(devs) == n and len(set(devs)) == n


def run_multi(n: int = 4) -> None:
    """Stream-parallel decode, GOP-sharded decode and GOP-sharded encode
    over an n-device mesh, each against its single-device result."""
    import jax

    from pfv_tpu import dataloader as dl
    from pfv_tpu.encoding import encode_video, encode_video_gops
    from pfv_tpu.parallel.gops import (decode_video_gops_packed,
                                       decode_video_rgb_gops, split_gop_runs)
    from pfv_tpu.parallel.streams import (decode_stream_batch_packed,
                                          make_stream_mesh)
    from pfv_tpu.utils.timing import equal, reference_products

    if len(jax.devices()) < n:
        raise SystemExit(f"--multi needs {n} devices, found "
                         f"{len(jax.devices())}")
    # four distinct 1080p clips: the two GOPs of each committed corpus
    clips = []
    for name in ("1080p", "1080p_pan"):
        subs, _ = split_gop_runs(load_corpus(name), 2)
        clips += subs
    mesh = make_stream_mesh(n)
    t = time.perf_counter()
    (y, u, v), gmean = decode_stream_batch_packed(clips[:n], mesh,
                                                  want="yuv")
    jax.block_until_ready((y, u, v))
    log(f"multi streams: {n} x 1080p in {time.perf_counter() - t:.3f} s "
        f"(compile included), shards on {len(y.sharding.device_set)} "
        f"devices")
    check("streams: one shard per device", _on_own_devices(y, n))
    for s in range(n):
        single = dl.decode_video_yuv(clips[s])
        check(f"streams: clip {s} == single-device decode",
              equal((y[s], u[s], v[s]), tuple(map(np.asarray, single))))
        check(f"streams: clip {s} == ref_decode",
              equal((y[s], u[s], v[s]), reference_products(clips[s])["yuv"]))

    # one 1080p clip with n two-frame GOPs, encoded sequentially and
    # GOP-sharded
    ys, us, vs = synth_clip(2 * n, 1920, 1080)
    gop_mesh = make_stream_mesh(n, axis="gops")
    t = time.perf_counter()
    data = encode_video(ys, us, vs, 30, 2, keyframes=2)
    t_seq = time.perf_counter() - t
    t = time.perf_counter()
    data_gops = encode_video_gops(ys, us, vs, 30, 2, keyframes=2,
                                  mesh=gop_mesh)
    t_gops = time.perf_counter() - t
    log(f"multi encode: {2 * n} frames 1080p, sequential {t_seq:.3f} s, "
        f"GOP-sharded {t_gops:.3f} s (compile included)")
    check("GOP-sharded encode == encode_video (byte-identical)",
          data_gops == data)

    ref = reference_products(data)
    single = tuple(map(np.asarray, dl.decode_video_yuv(data)))
    check("single-device decode == ref_decode", equal(single, ref["yuv"]))
    t = time.perf_counter()
    yuv = decode_video_gops_packed(data, mesh=gop_mesh, want="yuv")
    jax.block_until_ready(yuv)
    log(f"multi gops packed: {time.perf_counter() - t:.3f} s")
    check("GOP-sharded packed decode == single-device decode",
          equal(yuv, single))
    rgb = decode_video_rgb_gops(data, mesh=gop_mesh)
    check("GOP-sharded RGB decode == single-device RGB",
          equal(rgb, np.asarray(dl.decode_video_rgb(data))))
    check("GOP-sharded RGB decode == ref_decode", equal(rgb, ref["rgb"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device path")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per measurement (median)")
    args = ap.parse_args(argv)

    import jax

    from pfv_tpu.utils.timing import card_line

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    t = time.perf_counter()
    if args.multi:
        run_multi()
    else:
        run_single(args.reps)
    log(f"total {time.perf_counter() - t:.1f} s")
    if _failed:
        print(f"chip_smoke: {len(_failed)} check(s) failed: {_failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
