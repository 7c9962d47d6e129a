"""GOP-parallel decode: shard one video's keyframe-delimited runs across
devices.

The PFV P-frame chain is sequential, but every I-frame resets the
prediction state, so keyframe-delimited GOPs are mutually independent
(SURVEY.md §2: "shard GOPs/streams across chips; within a GOP, frames stay
sequential via lax.scan"). This module splits a single stream into GOPs,
pads them to a common length, and decodes all GOPs as a vmapped scan —
optionally shard_mapped over a `gops` mesh axis so one long video saturates
multiple devices.

Padding frames are synthesized as all-skip P-frames (copy previous recon)
and dropped from the output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pfv_tpu import runtime
from pfv_tpu.dataloader import get_decoder


def _split_gops(info, idx, val, mvx, mvy, hc, ftype, qidx, pad_gops_to: int):
    """Regroup per-frame tensors into (G, L, ...) padded GOP tensors."""
    nb = info["total_blocks"]
    f = ftype.shape[0]
    starts = np.flatnonzero(ftype == 1)
    if starts.size == 0 or starts[0] != 0:
        raise ValueError("stream must start with an I-frame for GOP split")
    ends = np.append(starts[1:], f)
    lengths = ends - starts
    g = len(starts)
    gp = ((g + pad_gops_to - 1) // pad_gops_to) * pad_gops_to
    lmax = int(lengths.max())

    def pad_frames(arr, fill):
        out = np.full((gp, lmax) + arr.shape[1:], fill, dtype=arr.dtype)
        for i, (s, e) in enumerate(zip(starts, ends)):
            out[i, : e - s] = arr[s:e]
        return out

    mvx_g = pad_frames(mvx, 0)
    mvy_g = pad_frames(mvy, 0)
    hc_g = pad_frames(hc, 0)  # padding: all-skip P frames
    ftype_g = pad_frames(ftype.astype(np.int32), 2)
    qidx_g = pad_frames(qidx.astype(np.int32), 0)

    # remap sparse flat indices from frame space to (gop, slot) space
    per_frame = nb * 256
    frame_of = idx // per_frame
    gop_of = np.searchsorted(starts, frame_of, side="right") - 1
    slot_of = frame_of - starts[gop_of]
    new_idx = (gop_of.astype(np.int64) * lmax + slot_of) * per_frame + (
        idx % per_frame
    )
    order = np.argsort(new_idx, kind="stable")
    total = gp * lmax * per_frame
    if total >= 2**31:
        raise ValueError("GOP-padded video too large for int32 flat indexing")
    return (
        new_idx[order].astype(np.int32),
        val[order],
        mvx_g,
        mvy_g,
        hc_g,
        ftype_g,
        qidx_g,
        lengths,
        g,
    )


def decode_video_rgb_gops(
    data: bytes,
    mesh: Mesh | None = None,
    axis: str = "gops",
    num_threads: int = 0,
) -> jnp.ndarray:
    """Decode one .pfv stream with GOPs in parallel -> (F, H, W, 3) uint8.

    With a mesh, GOPs shard over `axis` (shard_map + vmap); without one,
    they still decode as a single vmapped launch on one device.
    """
    out = runtime.demux_file_sparse(data, num_threads)
    info = out[0]
    n_dev = mesh.shape[axis] if mesh is not None else 1
    (idx, val, mvx, mvy, hc, ftype, qidx, lengths, g) = _split_gops(
        info, *out[1:], pad_gops_to=n_dev
    )
    gp, lmax = mvx.shape[0], mvx.shape[1]
    dec = get_decoder(info["width"], info["height"], info["qtables"],
                      "mxu" if info.get("mv_absmax", 127) <= 16 else "gather")
    nb = info["total_blocks"]
    per_gop = lmax * nb * 256

    def impl(idxs, vals, *rest):
        # scatter into the (local) gop range, then vmap the per-GOP scan
        g_local = rest[0].shape[0]
        total = g_local * per_gop
        base = jax.lax.axis_index(axis) * total if mesh is not None else 0
        buf = jnp.zeros((total + 1,), jnp.int16)
        local = jnp.clip(idxs - base, 0, total)  # out-of-shard -> sacrificial
        keep = (idxs >= base) & (idxs < base + total)
        buf = buf.at[jnp.where(keep, local, total)].set(vals)
        dense = buf[:total].reshape(g_local, lmax, nb, 256)
        return jax.vmap(dec.decode_yuv_impl)(dense, *rest)

    # stitch GOPs back into frame order (constant gather maps)
    gather_g = np.concatenate(
        [np.full(l, i, dtype=np.int32) for i, l in enumerate(lengths)]
    )
    gather_s = np.concatenate([np.arange(l, dtype=np.int32) for l in lengths])

    def stitch_impl(ys, us, vs):
        from pfv_tpu.ops.color import yuv_to_rgb

        y = ys[gather_g, gather_s]
        u = us[gather_g, gather_s]
        v = vs[gather_g, gather_s]
        uu = jnp.repeat(jnp.repeat(u, 2, axis=1), 2, axis=2)
        vv = jnp.repeat(jnp.repeat(v, 2, axis=1), 2, axis=2)
        return yuv_to_rgb(y, uu[:, : y.shape[1], : y.shape[2]],
                          vv[:, : y.shape[1], : y.shape[2]])

    args_np = (idx, val, mvx, mvy, hc, ftype, qidx)
    if mesh is None:
        # single device: decode + stitch fused into one program
        fn = jax.jit(lambda *a: stitch_impl(*impl(*a)))
        dev_args = tuple(jnp.asarray(a) for a in args_np)
        return fn(*dev_args)
    else:
        specs = (P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis))
        fn = jax.jit(
            jax.shard_map(
                impl, mesh=mesh, in_specs=specs, out_specs=P(axis),
                check_vma=False,
            )
        )
        shardings = tuple(
            NamedSharding(mesh, s) for s in specs
        )
        dev_args = tuple(
            jax.device_put(a, s) for a, s in zip(args_np, shardings)
        )

    ys, us, vs = fn(*dev_args)  # (GP, L, h, w) sharded over gops
    # GSPMD inserts the cross-shard gathers for the frame-order stitch
    return jax.jit(stitch_impl)(ys, us, vs)


# ---------------------------------------------------------------------------
# Fast-path GOP sharding: split ONE stream at keyframe boundaries into
# per-device substreams AT THE CONTAINER LEVEL (header + contiguous packet
# runs + EOF), then decode them as a stream batch through the packed fast
# path — so each shard runs the identical program the single-device path
# runs. Shorter groups
# are padded with synthesized all-skip P-frame packets (decode as copies,
# sliced off by the frame-order stitch).
# ---------------------------------------------------------------------------

_HDR_FIXED = 8 + 4 + 4 * 2  # magic + version + (w, h, fps, nq) u16s


def _scan_packets(data: bytes):
    """Parse the container into (header_len, [(start, end, ptype, plen)]).
    Packet framing per FORMAT.md (dec.rs:179-219): u8 type + u32 len;
    type 0 = EOF, 1 = I-frame (len 0 = drop frame), 2 = P-frame, other =
    skipped by length."""
    import struct

    if data[:8] != b"PFVIDEO\0":
        raise ValueError("bad magic")
    nq = struct.unpack_from("<H", data, 18)[0]
    hl = _HDR_FIXED + nq * 64 * 2
    off, pkts = hl, []
    while off + 5 <= len(data):
        ptype, plen = struct.unpack_from("<BI", data, off)
        end = off + 5 + plen
        if ptype == 0:
            break
        pkts.append((off, end, ptype, plen))
        off = end
    return hl, pkts


def skip_pframe_packet(width: int, height: int) -> bytes:
    """A P-frame packet in which every block is skipped (no mvec, no
    coefficients): 16-byte all-zero normalized frequency table (no RLE
    symbols are ever read, and both Huffman builders accept an empty
    tree — huffman.rs:95-97), q-table indices (2, 3, 3) matching the
    encoder's P-frames (enc.rs:334-338), then two zero header bits per block, byte-aligned. The
    decoder reconstructs it as a bit-exact copy of the previous frame."""
    import struct

    from pfv_tpu.frame import pad16

    yb = (pad16(height) // 16) * (pad16(width) // 16)
    cb = (pad16(height // 2) // 16) * (pad16(width // 2) // 16)
    nblocks = yb + 2 * cb
    payload = bytes(16) + bytes([2, 3, 3]) + bytes((2 * nblocks + 7) // 8)
    return struct.pack("<BI", 2, len(payload)) + payload


def split_gop_runs(data: bytes, n: int):
    """Split one .pfv stream into n same-geometry substreams of contiguous
    keyframe-delimited GOP runs, frame counts balanced and padded to equal
    length with all-skip P packets.

    Returns (substreams: list[bytes], true_frames: list[int])."""
    import struct

    hl, pkts = _scan_packets(data)
    # GOP starts: real I-frames (len > 0). Drop frames (type 1, len 0)
    # consume a frame slot but do NOT reset prediction (dec.rs:188-195).
    starts = [i for i, (_, _, t, l) in enumerate(pkts) if t == 1 and l > 0]
    if not starts or starts[0] != 0:
        raise ValueError("stream must start with an I-frame for GOP split")
    if len(starts) < n:
        raise ValueError(
            f"stream has {len(starts)} GOPs < {n} devices; GOP sharding "
            "needs at least one GOP per device")
    frames_of = [1 if t in (1, 2) else 0 for (_, _, t, _) in pkts]
    total_frames = sum(frames_of)

    # balanced contiguous grouping: cut when the running frame count
    # passes the proportional target (always at a GOP boundary)
    bounds = [0]
    acc = 0
    si = 1
    for g, s in enumerate(starts):
        e = starts[g + 1] if g + 1 < len(starts) else len(pkts)
        acc += sum(frames_of[s:e])
        gops_left = len(starts) - (g + 1)
        if si < n and gops_left >= (n - si) and (
                acc >= total_frames * si / n      # proportional target hit
                or gops_left == (n - si)):        # must cut: 1 GOP/group left
            bounds.append(g + 1)
            si += 1
    bounds.append(len(starts))

    width = struct.unpack_from("<H", data, 12)[0]
    height = struct.unpack_from("<H", data, 14)[0]
    header = data[:hl]
    eof = struct.pack("<BI", 0, 0)
    pad_pkt = skip_pframe_packet(width, height)

    groups, counts = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        p0 = pkts[starts[a]][0]
        p1 = pkts[starts[b]][0] if b < len(starts) else pkts[-1][1]
        i0 = starts[a]
        i1 = starts[b] if b < len(starts) else len(pkts)
        groups.append(data[p0:p1])
        counts.append(sum(frames_of[i0:i1]))
    fmax = max(counts)
    subs = [header + g + pad_pkt * (fmax - c) + eof
            for g, c in zip(groups, counts)]
    return subs, counts


def decode_video_gops_packed(
    data: bytes,
    mesh: Mesh | None = None,
    axis: str = "gops",
    num_threads: int = 0,
    want: str = "yuv",
):
    """Decode ONE .pfv stream with GOP runs sharded across the mesh, each
    shard running the packed fast path end-to-end.

    Returns the frame-ordered product: (F, H, W) y/u/v planes for
    want="yuv", (F, H, W, 3) for "rgb". The frame-order stitch is a
    constant-map gather jitted over the sharded group outputs (GSPMD
    inserts the cross-shard collectives)."""
    from pfv_tpu.parallel.streams import (
        decode_stream_batch_packed, make_stream_mesh)

    if mesh is None:
        mesh = make_stream_mesh(axis=axis)
    n = mesh.shape[axis]
    subs, counts = split_gop_runs(data, n)
    res, _ = decode_stream_batch_packed(subs, mesh=mesh,
                                        num_threads=num_threads, want=want)

    gather_g = np.concatenate(
        [np.full(c, i, dtype=np.int32) for i, c in enumerate(counts)])
    gather_s = np.concatenate(
        [np.arange(c, dtype=np.int32) for c in counts])

    def stitch(p):
        return p[gather_g, gather_s]

    if want == "yuv":
        return tuple(jax.jit(stitch)(p) for p in res)
    return jax.jit(stitch)(res)
