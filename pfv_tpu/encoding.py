"""Batch encoder: encode a whole video as one device program + host mux.

The streaming `pfv_tpu.Encoder` round-trips coefficients per frame, which is
correct but pays per-frame transfer latency. This fast path runs the entire
encode — padding, motion search, residuals, forward DCT, quantization, and
in-loop reconstruction (the sequential dependency rides the lax.scan carry)
— in one jitted program, then compacts nonzero coefficients on device so the
device->host fetch is sparse. The host muxes payloads with the native C++
entropy coder. Produces byte-identical output to the streaming Encoder.

Two-pass exact sizing: pass 1 computes only the nonzero count (device
compute is ~free; data-dependent output shapes are not expressible in one
XLA program), pass 2 re-encodes and compacts with a bucketed static cap.
"""

from __future__ import annotations

import struct
from functools import lru_cache
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pfv_tpu import runtime
from pfv_tpu.frame import pad16
from pfv_tpu.ops.blocks import block_origins, blocks_to_plane, plane_to_blocks
from pfv_tpu.ops.iframe import decode_blocks, encode_blocks
from pfv_tpu.ops.pframe import decode_delta_blocks, encode_plane_delta
from pfv_tpu.ops.quant import derive_q_tables

PFV_MAGIC = b"PFVIDEO\0"
PFV_VERSION = 211

_CAP_BUCKET = 1 << 17


@lru_cache(maxsize=16)
def _make_encoder(width: int, height: int, quality: int):
    """Jitted whole-video encode scan for one geometry + quality."""
    from pfv_tpu import config

    config.enable_compile_cache()
    qt = derive_q_tables(quality)  # numpy tables -> program constants
    px_err = np.float32(quality) * np.float32(1.5)
    min_err = np.float32(px_err * px_err * np.float32(256.0))

    ly = (pad16(height), pad16(width))
    lc = (pad16(height // 2), pad16(width // 2))
    yb = (ly[0] // 16) * (ly[1] // 16)
    cb = (lc[0] // 16) * (lc[1] // 16)
    nb = yb + 2 * cb
    oy = block_origins(*ly)
    oc = block_origins(*lc)
    plane_meta = (
        (ly, oy, "intra_l", "inter_l"),
        (lc, oc, "intra_c", "inter_c"),
        (lc, oc, "intra_c", "inter_c"),
    )

    def step(carry, x):
        yf, uf, vf, is_key = x
        frames = (yf, uf, vf)

        def intra(_):
            coeffs_all, recon_all = [], []
            for i, (shape, _, kq, _kq2) in enumerate(plane_meta):
                blocks = plane_to_blocks(frames[i])
                c = encode_blocks(blocks, jnp.asarray(qt[kq]))
                recon = blocks_to_plane(
                    decode_blocks(c, jnp.asarray(qt[kq])), *shape
                )
                coeffs_all.append(c.reshape(-1, 256))
                recon_all.append(recon)
            n = sum(c.shape[0] for c in coeffs_all)
            return (
                jnp.concatenate(coeffs_all, axis=0),
                jnp.zeros(n, jnp.int8),
                jnp.zeros(n, jnp.int8),
                jnp.ones(n, bool),
                tuple(recon_all),
            )

        def inter(_):
            coeffs_all, mvx_all, mvy_all, hc_all, recon_all = [], [], [], [], []
            for i, (shape, (by, bx), _kq, kq) in enumerate(plane_meta):
                q = jnp.asarray(qt[kq])
                blocks = plane_to_blocks(frames[i])
                byj, bxj = jnp.asarray(by), jnp.asarray(bx)
                c, mvx, mvy, hc = encode_plane_delta(
                    blocks, carry[i], byj, bxj, q, jnp.float32(min_err)
                )
                recon = blocks_to_plane(
                    decode_delta_blocks(c, q, carry[i], byj, bxj, mvy, mvx,
                                        hc, mc_mode="mxu"),
                    *shape,
                )
                coeffs_all.append(c.reshape(-1, 256))
                mvx_all.append(mvx.astype(jnp.int8))
                mvy_all.append(mvy.astype(jnp.int8))
                hc_all.append(hc)
                recon_all.append(recon)
            return (
                jnp.concatenate(coeffs_all, axis=0),
                jnp.concatenate(mvx_all),
                jnp.concatenate(mvy_all),
                jnp.concatenate(hc_all),
                tuple(recon_all),
            )

        coeffs, mvx, mvy, hc, recon = jax.lax.cond(is_key, intra, inter, None)
        return recon, (coeffs, mvx, mvy, hc)

    def encode_scan(yf, uf, vf, is_key):
        init = (
            jnp.zeros(ly, dtype=jnp.uint8),
            jnp.full(lc, 128, dtype=jnp.uint8),
            jnp.full(lc, 128, dtype=jnp.uint8),
        )
        _, (coeffs, mvx, mvy, hc) = jax.lax.scan(step, init, (yf, uf, vf, is_key))
        return coeffs, mvx, mvy, hc  # (F, nb, 256) i16, (F, nb) ...

    @jax.jit
    def count_nnz(yf, uf, vf, is_key):
        coeffs, _, _, hc = encode_scan(yf, uf, vf, is_key)
        # skipped blocks carry no coefficients in the bitstream
        live = coeffs * hc[..., None].astype(jnp.int16)
        return jnp.sum(live != 0)

    def compact(yf, uf, vf, is_key, cap: int):
        coeffs, mvx, mvy, hc = encode_scan(yf, uf, vf, is_key)
        live = coeffs * hc[..., None].astype(jnp.int16)
        flat = live.reshape(-1)
        total = flat.shape[0]
        idx = jnp.nonzero(flat, size=cap, fill_value=total)[0].astype(jnp.int32)
        flatp = jnp.concatenate([flat, jnp.zeros(1, jnp.int16)])
        val = flatp[idx]
        return idx, val, mvx, mvy, hc

    compact_jits: dict[int, object] = {}
    last_nnz: list[int] = [0]  # per-(geometry, quality) guess cache

    def _run_compact(args, cap):
        if cap not in compact_jits:
            compact_jits[cap] = jax.jit(lambda *a: compact(*a, cap=cap))
        return compact_jits[cap](*args)

    def encode(yf, uf, vf, is_key, nnz_hint: int | None = None, timer=None):
        """Returns host (idx, val, mvx, mvy, has_coeff, nnz) numpy arrays.

        Avoids a device round-trip when possible: the previous call's nnz
        (with a 1.5x margin) guesses the compaction cap; a full guess buffer
        (possible overflow) falls back to the exact two-pass path.
        `timer` (optional StageTimer) splits upload+device vs fetch time.
        """
        import contextlib

        stage = timer.stage if timer is not None else (
            lambda name: contextlib.nullcontext()
        )
        total = 0
        with stage("h2d upload"):
            args = (jnp.asarray(yf), jnp.asarray(uf), jnp.asarray(vf),
                    jnp.asarray(is_key))
            jax.block_until_ready(args)

        def bucket(n):
            return max(
                _CAP_BUCKET, ((n + _CAP_BUCKET - 1) // _CAP_BUCKET) * _CAP_BUCKET
            )

        if nnz_hint is not None:
            cap = bucket(nnz_hint + 1)
        elif last_nnz[0] > 0:
            cap = bucket(int(last_nnz[0] * 1.5) + 1)
        else:
            # exact (scalar fetch); +1 guarantees a padding sentinel slot
            with stage("nnz count pass"):
                cap = bucket(int(count_nnz(*args)) + 1)

        with stage("device encode"):
            outs = _run_compact(args, cap)
            jax.block_until_ready(outs)
        with stage("d2h fetch"):
            idx, val, mvx, mvy, hc = map(np.asarray, outs)
        total = mvx.shape[0] * mvx.shape[1] * 256
        # padding entries carry index == total; a full buffer means the
        # guess may have overflowed -> redo with the exact count
        if idx[-1] != total:
            if nnz_hint is None:
                cap = bucket(int(count_nnz(*args)) + 1)
                idx, val, mvx, mvy, hc = map(np.asarray, _run_compact(args, cap))
            if idx[-1] != total:
                raise RuntimeError("coefficient compaction overflow")
        nnz = int(np.searchsorted(idx, total))
        last_nnz[0] = nnz
        return idx, val, mvx, mvy, hc, nnz

    meta = {"nb": nb, "yb": yb, "cb": cb, "ly": ly, "lc": lc, "qt": qt}
    return encode, meta


@lru_cache(maxsize=16)
def _make_gop_encoder(width: int, height: int, quality: int, lmax: int):
    """vmappable GOP-parallel encoder: slot 0 of each GOP is the I-frame.

    Unlike _make_encoder's lax.cond step, this step is branch-free (both
    intra and inter paths computed, `where` selects) so it vmaps across the
    GOP axis — every GOP of a video encodes simultaneously, and the GOP axis
    can shard across chips. Byte-identical outputs to the sequential path.
    """
    from pfv_tpu import config

    config.enable_compile_cache()
    qt = derive_q_tables(quality)
    px_err = np.float32(quality) * np.float32(1.5)
    min_err = np.float32(px_err * px_err * np.float32(256.0))

    ly = (pad16(height), pad16(width))
    lc = (pad16(height // 2), pad16(width // 2))
    yb = (ly[0] // 16) * (ly[1] // 16)
    cb = (lc[0] // 16) * (lc[1] // 16)
    nb = yb + 2 * cb
    plane_meta = (
        (ly, block_origins(*ly), "intra_l", "inter_l"),
        (lc, block_origins(*lc), "intra_c", "inter_c"),
        (lc, block_origins(*lc), "intra_c", "inter_c"),
    )

    from pfv_tpu.ops.motion import motion_search
    from pfv_tpu.ops.pframe import (
        apply_residuals,
        calc_residuals,
        encode_delta_blocks,
    )

    def step(carry, x):
        yf, uf, vf, is_key = x
        frames = (yf, uf, vf)
        coeffs_all, mvx_all, mvy_all, hc_all, recon_all = [], [], [], [], []
        for i, (shape, (by, bx), kqi, kqp) in enumerate(plane_meta):
            qi = jnp.asarray(qt[kqi])
            qp = jnp.asarray(qt[kqp])
            byj, bxj = jnp.asarray(by), jnp.asarray(bx)
            blocks = plane_to_blocks(frames[i])

            # intra path
            ci = encode_blocks(blocks, qi)
            recon_i = decode_blocks(ci, qi)

            # inter path (pred == winning search window by construction)
            mvx, mvy, err, win = motion_search(blocks, carry[i], byj, bxj)
            hc = err.astype(jnp.float32) > jnp.float32(min_err)
            cp = encode_delta_blocks(calc_residuals(blocks, win), qp)
            res_u8 = decode_blocks(cp, qp)
            recon_p = jnp.where(
                hc[:, None, None], apply_residuals(res_u8, win), win
            )

            coeffs_all.append(
                jnp.where(is_key, ci, cp).reshape(-1, 256)
            )
            mvx_all.append(jnp.where(is_key, 0, mvx).astype(jnp.int8))
            mvy_all.append(jnp.where(is_key, 0, mvy).astype(jnp.int8))
            hc_all.append(jnp.where(is_key, True, hc))
            recon_all.append(
                blocks_to_plane(jnp.where(is_key, recon_i, recon_p), *shape)
            )
        out = (
            jnp.concatenate(coeffs_all, axis=0),
            jnp.concatenate(mvx_all),
            jnp.concatenate(mvy_all),
            jnp.concatenate(hc_all),
        )
        return tuple(recon_all), out

    def encode_gop(yf, uf, vf, is_key):
        init = (
            jnp.zeros(ly, dtype=jnp.uint8),
            jnp.full(lc, 128, dtype=jnp.uint8),
            jnp.full(lc, 128, dtype=jnp.uint8),
        )
        _, out = jax.lax.scan(step, init, (yf, uf, vf, is_key))
        return out  # (L, nb, 256) i16, (L, nb) i8/i8/bool

    def encode_all(yg, ug, vg, key_g):
        """(G, L, Hp, Wp) padded GOP frames -> stacked per-GOP outputs."""
        return jax.vmap(encode_gop)(yg, ug, vg, key_g)

    @jax.jit
    def count_max_nnz(yg, ug, vg, key_g):
        """Max per-GOP nonzero count (sizes the compaction cap; one scalar
        device->host fetch instead of the full dense tensor)."""
        coeffs, _, _, hc = encode_all(yg, ug, vg, key_g)
        live = coeffs * hc[..., None].astype(jnp.int16)
        return jnp.max(
            jnp.sum(live.reshape(live.shape[0], -1) != 0, axis=1)
        )

    def make_sparse(cap: int):
        """Per-GOP on-device compaction: (G, cap) idx/val instead of the
        dense (G, L, nb, 256) tensor — the D2H fetch shrinks from
        dense-size to ~bitstream-size. Padding entries carry idx == L*nb*256."""

        def enc_sparse(yg, ug, vg, key_g):
            coeffs, mvx, mvy, hc = encode_all(yg, ug, vg, key_g)
            live = coeffs * hc[..., None].astype(jnp.int16)
            flatg = live.reshape(live.shape[0], -1)
            total = flatg.shape[1]

            def one(flat):
                idx = jnp.nonzero(flat, size=cap, fill_value=total)[0]
                val = jnp.concatenate([flat, jnp.zeros(1, jnp.int16)])[idx]
                return idx.astype(jnp.int32), val

            idx, val = jax.vmap(one)(flatg)
            return idx, val, mvx, mvy, hc

        return enc_sparse

    meta = {"nb": nb, "ly": ly, "lc": lc, "qt": qt, "lmax": lmax}
    return encode_all, count_max_nnz, make_sparse, meta


def encode_video_gops(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    framerate: int,
    quality: int,
    keyframes: Sequence[bool] | int = 15,
    mesh=None,
    axis: str = "gops",
) -> bytes:
    """GOP-parallel encode_video: byte-identical output, every GOP encoded
    concurrently (vmapped; sharded over `axis` when a mesh is given)."""
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    f, h, w = y.shape
    if w % 2 or h % 2:
        raise ValueError("width and height must be even (4:2:0 chroma)")
    if isinstance(keyframes, int):
        is_key = np.arange(f) % keyframes == 0
    else:
        is_key = np.asarray(keyframes, dtype=bool)
    if not is_key[0]:
        raise ValueError("first frame must be a keyframe")

    starts = np.flatnonzero(is_key)
    ends = np.append(starts[1:], f)
    lengths = ends - starts
    lmax = int(lengths.max())
    g = len(starts)
    n_dev = mesh.shape[axis] if mesh is not None else 1
    gp = ((g + n_dev - 1) // n_dev) * n_dev

    encode_all, count_max_nnz, make_sparse, meta = _make_gop_encoder(
        w, h, quality, lmax
    )
    ly, lc, nb = meta["ly"], meta["lc"], meta["nb"]

    def group(frames, shape, clear):
        padded = _pad_frames(frames, *shape, clear)
        out = np.full((gp, lmax) + shape, clear, dtype=np.uint8)
        for i, (s, e) in enumerate(zip(starts, ends)):
            out[i, : e - s] = padded[s:e]
        return out

    yg = group(y, ly, 0)
    ug = group(u, lc, 128)
    vg = group(v, lc, 128)
    key_g = np.zeros((gp, lmax), dtype=bool)
    key_g[:, 0] = True  # slot 0 of every GOP is the I-frame

    if mesh is None:
        args = tuple(jnp.asarray(a) for a in (yg, ug, vg, key_g))
    else:
        spec = NamedSharding(mesh, P(axis))
        args = tuple(_jax.device_put(a, spec) for a in (yg, ug, vg, key_g))

    # size the compaction cap from a scalar count fetch, then run the
    # sparse encode (shard_mapped over the GOP axis when a mesh is given)
    def bucket(n):
        return max(
            _CAP_BUCKET, ((n + _CAP_BUCKET - 1) // _CAP_BUCKET) * _CAP_BUCKET
        )

    cap = bucket(int(count_max_nnz(*args)) + 1)
    enc_sparse = make_sparse(cap)
    if mesh is None:
        fn = _jax.jit(enc_sparse)
    else:
        fn = _jax.jit(
            _jax.shard_map(
                enc_sparse, mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis)),
                out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
                check_vma=False,
            )
        )
    idxg, valg, mvx, mvy, hc = (np.asarray(o) for o in fn(*args))

    # mux in frame order from the sparse streams, dropping GOP padding
    out = bytearray()
    out += PFV_MAGIC
    out += struct.pack("<IHHHH", PFV_VERSION, w, h, framerate, 4)
    qt = meta["qt"]
    for k in ("intra_l", "intra_c", "inter_l", "inter_c"):
        out += qt[k].astype("<u2").tobytes()
    per_frame = nb * 256
    slot_edges = np.arange(lmax + 1) * per_frame
    for gi, (s, e) in enumerate(zip(starts, ends)):
        idx_g, val_g = idxg[gi], valg[gi]
        if idx_g[-1] != lmax * per_frame:
            raise RuntimeError("GOP coefficient compaction overflow")
        bounds = np.searchsorted(idx_g, slot_edges)
        for slot in range(e - s):
            lo, hi = bounds[slot], bounds[slot + 1]
            idx_local = idx_g[lo:hi] - np.int32(slot * per_frame)
            if slot == 0:
                payload = runtime.encode_iframe_payload_sparse(
                    idx_local, val_g[lo:hi], nb, (0, 1, 1)
                )
                out += struct.pack("<BI", 1, len(payload))
            else:
                payload = runtime.encode_pframe_payload_sparse(
                    idx_local, val_g[lo:hi], mvx[gi, slot], mvy[gi, slot],
                    hc[gi, slot].astype(np.uint8), (2, 3, 3),
                )
                out += struct.pack("<BI", 2, len(payload))
            out += payload
    out += struct.pack("<BI", 0, 0)
    return bytes(out)


def _pad_frames(frames: np.ndarray, ph: int, pw: int, clear: int) -> np.ndarray:
    f, h, w = frames.shape
    if (h, w) == (ph, pw):
        return np.ascontiguousarray(frames)
    out = np.full((f, ph, pw), clear, dtype=np.uint8)
    out[:, :h, :w] = frames
    return out


def encode_video(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    framerate: int,
    quality: int,
    keyframes: Sequence[bool] | int = 15,
    timer=None,
) -> bytes:
    """Encode 4:2:0 planes (F,H,W), (F,H/2,W/2) x2 uint8 -> .pfv bytes.

    `keyframes`: an int interval (frame 0, interval, 2*interval, ... are
    I-frames, like the reference README example) or an explicit bool mask.
    Byte-identical to feeding the same frames through pfv_tpu.Encoder.
    `timer` (optional utils.profiling.StageTimer) records the stage split
    (upload / device encode / fetch / host mux).
    """
    import contextlib

    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext()
    )
    f, h, w = y.shape
    if w % 2 or h % 2:
        raise ValueError("width and height must be even (4:2:0 chroma)")
    if u.shape != (f, h // 2, w // 2) or v.shape != u.shape:
        raise ValueError(
            f"chroma planes must be (F, H/2, W/2); got {u.shape} / {v.shape} "
            f"for luma {y.shape}"
        )
    if isinstance(keyframes, int):
        is_key = np.arange(f) % keyframes == 0
    else:
        is_key = np.asarray(keyframes, dtype=bool)
        assert is_key.shape == (f,)
    assert is_key[0], "first frame must be a keyframe"

    encode, meta = _make_encoder(w, h, quality)
    ly, lc = meta["ly"], meta["lc"]
    yp = _pad_frames(y, *ly, 0)
    up = _pad_frames(u, *lc, 128)
    vp = _pad_frames(v, *lc, 128)

    idx, val, mvx, mvy, hc, nnz = encode(yp, up, vp, is_key, timer=timer)
    idx, val = idx[:nnz], val[:nnz]

    # mux on host straight from the sparse stream (no per-frame densify):
    # O(nonzeros) C++ entropy per frame
    with stage("host mux"):
        out = bytearray()
        out += PFV_MAGIC
        out += struct.pack("<IHHHH", PFV_VERSION, w, h, framerate, 4)
        qt = meta["qt"]
        for k in ("intra_l", "intra_c", "inter_l", "inter_c"):
            out += qt[k].astype("<u2").tobytes()

        nb = meta["nb"]
        per_frame = nb * 256
        # frame boundaries in the sorted sparse stream
        bounds = np.searchsorted(idx, np.arange(f + 1) * per_frame)
        for t in range(f):
            lo, hi = bounds[t], bounds[t + 1]
            idx_local = idx[lo:hi] - np.int32(t * per_frame)
            if is_key[t]:
                payload = runtime.encode_iframe_payload_sparse(
                    idx_local, val[lo:hi], nb, (0, 1, 1)
                )
                out += struct.pack("<BI", 1, len(payload))
            else:
                payload = runtime.encode_pframe_payload_sparse(
                    idx_local, val[lo:hi], mvx[t], mvy[t],
                    hc[t].astype(np.uint8), (2, 3, 3),
                )
                out += struct.pack("<BI", 2, len(payload))
            out += payload
        out += struct.pack("<BI", 0, 0)  # EOF
    return bytes(out)
