#!/usr/bin/env python3
"""Decode timing of the committed corpora on one GPU, in one process.

    python bench.py [--reps N] [--corpus NAME ...]

Corpora (.bench_cache/, full size): 1080p (120 frames, q2), 1080p pan
(the dense-texture worst case) and sd (512x384, 161 frames: the
reference's own speed-test workload). Each corpus is first decoded to
per-frame plane checksums and checked against the scalar C++ reference
decoder (runtime.ref_decode); then each product (YUV, RGBA, RGB) of the
dataloader entry points is timed end to end (host demux + upload + device
decode) and device-only (decode of already-uploaded units), each run to
completion (block_until_ready), median of --reps runs.

Prints the card's name and power limit, then one JSON line per corpus.
Exits non-zero without a GPU or when a checksum differs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CORPORA = {
    "1080p": "corpus_1920x1080_q2_120f.pfv",
    "1080p_pan": "corpus_1920x1080_q2_120f_pan.pfv",
    "sd": "corpus_512x384_q2_161f.pfv",
}


def bench_corpus(name: str, reps: int) -> dict:
    from pfv_tpu import dataloader, runtime
    from pfv_tpu.utils.timing import median_ms, time_path

    with open(os.path.join(HERE, ".bench_cache", CORPORA[name]), "rb") as f:
        data = f.read()
    n, y, u, v, _ = runtime.ref_decode(data)
    want = dataloader.plane_checksums(y, u, v)
    del y, u, v
    got = dataloader.decode_video_checksums(data)
    if got.shape != want.shape or not (got == want).all():
        raise SystemExit(f"{name}: checksums differ from ref_decode")
    ref_ms = median_ms(lambda: runtime.ref_decode(data, emit=False), reps)
    out = {"corpus": name, "frames": n, "bytes": len(data),
           "ref_decode_ms": ref_ms,
           "path": dataloader.probe_decode_path(data), "products": {}}
    for want_p in ("yuv", "rgba", "rgb"):
        # checksums already verified the planes; time only
        r = time_path(data, want_p, None, reps)
        out["products"][want_p] = {
            "e2e_ms": r["e2e_ms"], "device_ms": r["device_ms"],
            "e2e_fps": n / r["e2e_ms"] * 1e3,
            "device_fps": n / r["device_ms"] * 1e3}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--corpus", nargs="*", choices=sorted(CORPORA),
                    default=list(CORPORA))
    args = ap.parse_args(argv)

    import jax

    from pfv_tpu.utils.timing import card_line

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    for name in args.corpus:
        res = bench_corpus(name, args.reps)
        res["device"] = dev.device_kind
        res["card"] = card
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
