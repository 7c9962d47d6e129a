"""pfv command-line tool: encode / decode / info / bench.

Replaces the reference's stale SDL2 demo (C14) with a scriptable interface.
Frame I/O uses .npy ((F, H, W, 3) uint8 RGB) everywhere; PNG directories are
supported when Pillow is installed.

Usage:
  python -m pfv_tpu info clip.pfv
  python -m pfv_tpu encode clip.pfv --input frames.npy --fps 30 --quality 3
  python -m pfv_tpu encode clip.pfv --synth 161 --size 512x384 --quality 2
  python -m pfv_tpu decode clip.pfv --output frames.npy
  python -m pfv_tpu bench clip.pfv --runs 10
"""

from __future__ import annotations

import argparse
import os
import struct
import time

import numpy as np


def _load_rgb(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
        assert arr.ndim == 4 and arr.shape[-1] == 3 and arr.dtype == np.uint8
        return arr
    if os.path.isdir(path):
        from PIL import Image  # optional dependency

        files = sorted(
            f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg"))
        )
        return np.stack([np.asarray(Image.open(os.path.join(path, f)).convert("RGB"))
                         for f in files])
    raise SystemExit(f"unsupported input: {path} (use .npy or a PNG directory)")


def _save_rgb(path: str, rgb: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, rgb)
        return
    if path.endswith("/") or not os.path.splitext(path)[1]:
        from PIL import Image

        os.makedirs(path, exist_ok=True)
        for i, frame in enumerate(rgb):
            Image.fromarray(frame).save(os.path.join(path, f"{i:04d}.png"))
        return
    raise SystemExit(f"unsupported output: {path}")


def cmd_info(args) -> None:
    from pfv_tpu import runtime

    data = open(args.file, "rb").read()
    info, off = runtime.parse_header(data)
    print(f"{args.file}: {info['width']}x{info['height']} @ "
          f"{info['framerate']} fps, {info['qtables'].shape[0]} q-tables, "
          f"{len(data)} bytes")
    counts = {0: 0, 1: 0, 2: 0, "drop": 0, "other": 0}
    pos = off
    while pos + 5 <= len(data):
        ptype, plen = struct.unpack_from("<BI", data, pos)
        pos += 5 + plen
        if ptype == 1 and plen == 0:
            counts["drop"] += 1
        elif ptype in counts:
            counts[ptype] += 1
        else:
            counts["other"] += 1
        if ptype == 0:
            break
    print(f"packets: {counts[1]} I-frames, {counts[2]} P-frames, "
          f"{counts['drop']} drop frames, {counts['other']} unknown, "
          f"EOF {'present' if counts[0] else 'MISSING'}")
    if args.frames:
        names = {0: "EOF", 1: "I", 2: "P"}
        pos, i = off, 0
        while pos + 5 <= len(data):
            ptype, plen = struct.unpack_from("<BI", data, pos)
            pos += 5 + plen
            label = "drop" if (ptype == 1 and plen == 0) else names.get(ptype, f"type{ptype}")
            print(f"  packet {i:4d}: {label:>5}  {plen:8d} bytes")
            i += 1
            if ptype == 0:
                break


def cmd_encode(args) -> None:
    from pfv_tpu.encoding import encode_video
    from pfv_tpu.ops.color import rgb_to_yuv_np

    if args.synth:
        from pfv_tpu.utils.synth import synth_rgb_frame

        w, h = map(int, args.size.split("x"))
        rgb = np.stack([synth_rgb_frame(t, w, h) for t in range(args.synth)])
    else:
        rgb = _load_rgb(args.input)
    f, h, w, _ = rgb.shape
    y, u, v = rgb_to_yuv_np(rgb)
    u = u[:, ::2, ::2].copy()
    v = v[:, ::2, ::2].copy()

    t0 = time.time()
    data = encode_video(y, u, v, args.fps, args.quality, args.keyframe_every)
    dt = time.time() - t0
    open(args.file, "wb").write(data)
    print(f"encoded {f} frames {w}x{h} q{args.quality} in {dt:.1f}s "
          f"({f/dt:.1f} fps) -> {args.file} ({len(data)} bytes)")


def cmd_decode(args) -> None:
    from pfv_tpu.dataloader import decode_video_rgb

    data = open(args.file, "rb").read()
    t0 = time.time()
    rgb = np.asarray(decode_video_rgb(data, num_threads=args.threads))
    dt = time.time() - t0
    print(f"decoded {rgb.shape[0]} frames {rgb.shape[2]}x{rgb.shape[1]} "
          f"in {dt:.1f}s ({rgb.shape[0]/dt:.1f} fps incl. readback)")
    _save_rgb(args.output, rgb)
    print(f"wrote {args.output}")


def cmd_play(args) -> None:
    """Terminal player: ANSI truecolor half-blocks, delta-time pacing.

    The functional replacement for the reference's SDL2 demo
    (demo/src/main.rs): advance_delta-driven playback with loop-on-EOF via
    Decoder.reset().
    """
    import shutil
    import sys
    import time

    from pfv_tpu import Decoder

    f = open(args.file, "rb")
    dec = Decoder(f)
    cols, rows = shutil.get_terminal_size((80, 24))
    tw = min(args.width or cols, cols)
    th = 2 * (rows - 2)  # half-blocks: 2 pixels per text row

    def render(frame) -> None:
        rgb = frame.to_rgb()
        h, w, _ = rgb.shape
        sw = min(tw, w)
        sh = min(th, max(2, int(sw * h / w * 0.5) * 2))
        ys = (np.arange(sh) * h // sh).astype(int)
        xs = (np.arange(sw) * w // sw).astype(int)
        img = rgb[np.ix_(ys, xs)]
        lines = ["\x1b[H"]
        for r in range(0, sh - 1, 2):
            top, bot = img[r], img[r + 1]
            lines.append(
                "".join(
                    f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                    f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                    for t, b in zip(top, bot)
                )
                + "\x1b[0m"
            )
        sys.stdout.write("\n".join(lines) + "\n")
        sys.stdout.flush()

    shown = [0]

    def on_frame(frame):
        render(frame)
        shown[0] += 1

    sys.stdout.write("\x1b[2J")  # clear
    last = time.perf_counter()
    try:
        while shown[0] < args.max_frames:
            now = time.perf_counter()
            alive = dec.advance_delta(now - last, on_frame)
            last = now
            if not alive:
                if not args.loop:
                    break
                dec.reset()
            time.sleep(0.002)
    except KeyboardInterrupt:
        pass
    finally:
        sys.stdout.write("\x1b[0m\n")
    print(f"played {shown[0]} frames @ {dec.framerate()} fps nominal")


def cmd_bench(args) -> None:
    """Decode speed harness mirroring the reference's test_decode_speed_2."""
    import jax

    from pfv_tpu import runtime
    from pfv_tpu.dataloader import decode_video_rgb

    data = open(args.file, "rb").read()
    n, *_ = runtime.ref_decode(data, emit=False)
    for run in range(args.runs):
        t0 = time.perf_counter()
        out = decode_video_rgb(data, num_threads=args.threads)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) * 1000
        print(f"RUN {run}: decoded {n} frames in {dt:.1f} ms "
              f"({n/dt*1000:.0f} fps)")


def cmd_verify(args) -> None:
    """Cross-check the device pipeline against the native scalar decoder."""
    from pfv_tpu import runtime
    from pfv_tpu.dataloader import decode_video_checksums, plane_checksums

    data = open(args.file, "rb").read()
    n, y, u, v, info = runtime.ref_decode(data)
    want = plane_checksums(y, u, v)
    got = decode_video_checksums(data, num_threads=args.threads)
    ok = got.shape == want.shape and bool((got == want).all())
    if ok:
        print(f"OK: {n} frames, device decode matches scalar decoder "
              f"(position-weighted checksums, all planes)")
    else:
        bad = np.argwhere(got != want)
        raise SystemExit(
            f"MISMATCH at frame/plane indices {bad[:8].tolist()} "
            f"({bad.shape[0]} of {want.size} checksums differ)"
        )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="pfv", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("info", help="print header + packet summary")
    s.add_argument("file")
    s.add_argument("--frames", action="store_true",
                   help="list every packet with its size")
    s.set_defaults(fn=cmd_info)

    s = sub.add_parser("encode", help="encode RGB frames to .pfv")
    s.add_argument("file")
    s.add_argument("--input", help=".npy (F,H,W,3) u8 or PNG directory")
    s.add_argument("--synth", type=int, default=0,
                   help="encode N synthetic frames instead of --input")
    s.add_argument("--size", default="512x384", help="WxH for --synth")
    s.add_argument("--fps", type=int, default=30)
    s.add_argument("--quality", type=int, default=5,
                   help="0 (finest) .. 10 (coarsest)")
    s.add_argument("--keyframe-every", type=int, default=15)
    s.set_defaults(fn=cmd_encode)

    def add_threads(sp):
        sp.add_argument("--threads", type=int, default=0,
                        help="host demux threads (0 = all cores), like the "
                             "reference's num_threads knob")

    s = sub.add_parser("decode", help="decode .pfv to RGB frames")
    s.add_argument("file")
    s.add_argument("--output", required=True, help=".npy or a directory")
    add_threads(s)
    s.set_defaults(fn=cmd_decode)

    s = sub.add_parser("bench", help="decode speed harness")
    s.add_argument("file")
    s.add_argument("--runs", type=int, default=10)
    add_threads(s)
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("verify", help="cross-check device decode vs scalar")
    s.add_argument("file")
    add_threads(s)
    s.set_defaults(fn=cmd_verify)

    s = sub.add_parser("play", help="terminal playback (ANSI half-blocks)")
    s.add_argument("file")
    s.add_argument("--loop", action="store_true", help="loop on EOF")
    s.add_argument("--width", type=int, default=0, help="max columns")
    s.add_argument("--max-frames", type=int, default=1 << 30)
    s.set_defaults(fn=cmd_play)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except FileNotFoundError as e:
        raise SystemExit(f"pfv: {e.filename}: no such file")
    except ValueError as e:
        raise SystemExit(f"pfv: {e}")


if __name__ == "__main__":
    main()
