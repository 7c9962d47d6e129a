"""Dataloader mode: decode whole videos to RGB tensors as one device program.

The threaded C++ demux turns a .pfv byte stream into compact per-frame
coefficient unit streams; a single jitted program then densifies them and
decodes every frame on device — the sequential P-frame dependency rides a
`lax.scan` carry (the reconstructed previous frame never leaves device
memory), and all macroblocks of a frame decode as one batched program.
Output lands in device memory as (F, H, W, 3) uint8 RGB (or packed RGBA,
YUV planes, or per-frame checksums), ready for model ingestion.

Two step implementations share the fused-canvas layout and are bit-exact
with each other and with the scalar reference decoder:
* on a GPU, the fused Pallas step kernel (ops/pallas/step_kernel.py):
  one kernel launch per frame does dequant + iDCT + motion compensation +
  reconstruction;
* elsewhere (and under PFV_STEP=0), the pure-XLA steps: "mxu" (band-select
  motion compensation, |mv| <= 16) or "gather" (any in-plane vector).

Structure-vs-reference: the reference decodes frame-by-frame through a rayon
pool (dec.rs:169-224); here the GOP chain is `lax.scan` (SURVEY.md §2
"long-context" mapping) and the macroblock axis is the batched kernel axis.
"""

from __future__ import annotations

import os
import threading
from functools import lru_cache
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pfv_tpu import runtime
from pfv_tpu.frame import pad16
from pfv_tpu.ops.blocks import block_origins, blocks_to_plane
from pfv_tpu.ops.color import yuv_to_rgb
from pfv_tpu.ops.iframe import decode_blocks
from pfv_tpu.ops.motion import gather_predictions
from pfv_tpu.ops.pframe import apply_residuals
from pfv_tpu.ops.quant import DCT_SCALE_FACTOR, INV_ZIGZAG_TABLE

KERNEL_MODES = ("kernel", "interpret")


class VideoDecoder(NamedTuple):
    """Jitted decode entry points + raw impls (for shard_map composition).

    `*_sparse` variants take (idx, val) coefficient pairs from
    runtime.demux_file_sparse and densify on device; `*_packed` variants
    take the (deltas, vals, meta) upload form of `demux_packed_host` — the
    fast path."""

    decode_rgb: Callable
    decode_yuv: Callable
    decode_rgb_impl: Callable
    decode_yuv_impl: Callable
    decode_rgb_sparse: Callable
    decode_yuv_sparse: Callable
    decode_rgb_sparse_impl: Callable
    decode_yuv_sparse_impl: Callable
    decode_checksums_sparse: Callable
    decode_rgb_packed: Callable
    decode_yuv_packed: Callable
    decode_checksums_packed: Callable
    decode_rgba_packed: Callable
    decode_packed_gops: Callable


class _Geometry(NamedTuple):
    """Fused-canvas geometry of one video size.

    All three planes live in ONE canvas: Y on top, U and V side by side
    below, so every per-step op runs once over all blocks. Motion windows
    never cross region boundaries: the demux validates each vector
    against its own plane's bounds."""

    ly: tuple[int, int]   # padded luma (rows, cols)
    lc: tuple[int, int]   # padded chroma (rows, cols)
    cw: int               # canvas columns
    chh: int              # canvas rows
    yb: int               # luma blocks
    cb: int               # blocks per chroma plane

    @property
    def gch(self) -> int:
        return self.chh // 16

    @property
    def gcw(self) -> int:
        return self.cw // 16

    @property
    def nbc(self) -> int:
        return self.gch * self.gcw


def _geometry(width: int, height: int) -> _Geometry:
    ly = (pad16(height), pad16(width))
    lc = (pad16(height // 2), pad16(width // 2))
    return _Geometry(
        ly, lc, max(ly[1], 2 * lc[1]), ly[0] + lc[0],
        (ly[0] // 16) * (ly[1] // 16), (lc[0] // 16) * (lc[1] // 16))


@lru_cache(maxsize=16)
def _canvas_perm(width: int, height: int) -> np.ndarray:
    """Stream block index (Y,U,V raster concat) -> canvas block index."""
    g = _geometry(width, height)
    gly, glc, gyw = g.ly[0] // 16, g.lc[1] // 16, g.ly[1] // 16
    ids = [r * g.gcw + c for r in range(gly) for c in range(gyw)]
    for off in (0, glc):
        ids += [(gly + r) * g.gcw + off + c
                for r in range(g.lc[0] // 16) for c in range(glc)]
    return np.asarray(ids, dtype=np.int32)


@lru_cache(maxsize=16)
def _make_decoder(width: int, height: int, qtables_key: bytes, nq: int,
                  mode: str = "mxu"):
    """Build the jitted decoders for one video geometry + q-table set.

    mode picks the step: "kernel" (the GPU step kernel), "interpret" (the
    same kernel in the Pallas interpreter — tests), "mxu" (XLA band-select
    motion compensation, valid for |mv| <= 16, i.e. every encoder-produced
    stream) or "gather" (XLA, full mv range for foreign streams).
    decode_video_* select per file (demux_packed_host).

    Everything closed over below is host numpy, never jax device arrays:
    numpy constants embed in the program instead of being re-uploaded per
    call.
    """
    from pfv_tpu import config

    config.enable_compile_cache()
    qtables = np.frombuffer(qtables_key, dtype=np.int32).reshape(nq, 64)
    geo = _geometry(width, height)
    ly, lc, cw, chh, yb, cb = geo
    gch, gcw, nbc = geo.gch, geo.gcw, geo.nbc
    nb = yb + 2 * cb
    oy = block_origins(*ly)
    oc = block_origins(*lc)
    plane_meta = (
        ("y", slice(0, yb), ly, oy),
        ("u", slice(yb, yb + cb), lc, oc),
        ("v", slice(yb + cb, yb + 2 * cb), lc, oc),
    )
    use_kernel = mode in KERNEL_MODES

    perm = _canvas_perm(width, height)
    # plane id per canvas block (dead filler blocks -> 0); q-table index
    # per canvas block is qidx[pob_c]
    pob_c = np.zeros(nbc, dtype=np.int32)
    pob_c[perm[yb : yb + cb]] = 1
    pob_c[perm[yb + cb :]] = 2
    canvas_init = np.zeros((chh, cw), dtype=np.uint8)
    canvas_init[ly[0] :, : 2 * lc[1]] = 128

    def step_canvas(canvas, x):
        # Plane-space step: only the iDCT works in block space (its 8x8
        # tiles demand it); MC is the band-select pass and the residual
        # apply/select are full-width elementwise.
        coeffs_c, mvx_c, mvy_c, hc_c, ftype, qidx = x
        is_intra = ftype == 1
        qt_all = jnp.asarray(qtables)
        q = qt_all[qidx[jnp.asarray(pob_c)]][:, None, :]  # (nbc, 1, 64)
        from pfv_tpu.ops.iframe import decode_blocks_i32
        from pfv_tpu.ops.motion import predict_plane_select

        res = blocks_to_plane(
            decode_blocks_i32(coeffs_c, q), chh, cw
        )  # (CH, CW) i32
        pred = predict_plane_select(
            canvas,
            mvy_c.reshape(gch, gcw),
            mvx_c.reshape(gch, gcw),
        ).astype(jnp.int32)
        hc_map = jnp.broadcast_to(
            hc_c.reshape(gch, 1, gcw, 1).astype(bool),
            (gch, 16, gcw, 16),
        ).reshape(chh, cw)
        inter = jnp.clip(pred + (res - 128) * 2, 0, 255)
        sel = jnp.where(hc_map, inter, pred)
        out = jnp.where(is_intra, res, sel).astype(jnp.uint8)
        return out, out

    def _slice_yuv(canvases):
        return (
            canvases[:, :height, :width],
            canvases[:, ly[0] : ly[0] + height // 2, : width // 2],
            canvases[:, ly[0] : ly[0] + height // 2,
                     lc[1] : lc[1] + width // 2],
        )

    def _to_canvas_order(coeffs, mvx, mvy, has_coeff, dtype_mv):
        f = coeffs.shape[0]
        permj = jnp.asarray(perm)
        # one-time remap into canvas block order (per clip, not per step)
        coeffs_c = jnp.zeros((f, nbc, 4, 64), jnp.int16).at[:, permj].set(
            coeffs.reshape(f, -1, 4, 64)
        )
        mvx_c = jnp.zeros((f, nbc), dtype_mv).at[:, permj].set(
            mvx.astype(dtype_mv)
        )
        mvy_c = jnp.zeros((f, nbc), dtype_mv).at[:, permj].set(
            mvy.astype(dtype_mv)
        )
        hc_c = jnp.zeros((f, nbc), jnp.uint8).at[:, permj].set(has_coeff)
        return coeffs_c, mvx_c, mvy_c, hc_c

    def decode_yuv_impl_mxu(coeffs, mvx, mvy, has_coeff, ftype, qidx):
        coeffs_c, mvx_c, mvy_c, hc_c = _to_canvas_order(
            coeffs, mvx, mvy, has_coeff, jnp.int32
        )
        _, canvases = jax.lax.scan(
            step_canvas,
            jnp.asarray(canvas_init),
            (coeffs_c, mvx_c, mvy_c, hc_c, ftype, qidx),
        )
        return _slice_yuv(canvases)

    # ---- GPU step kernel (mode "kernel" / "interpret") ---------------------
    # canvas block -> stream block (dead filler blocks -> nb: zero coeffs)
    src_of_c = np.full(nbc, nb, dtype=np.int32)
    src_of_c[perm] = np.arange(nb, dtype=np.int32)
    # dequant multiplier per q-table and row-major position r (quirk Q1:
    # it belongs to the zigzag slot INV_ZIGZAG[r] that position r reads)
    mult_table = (qtables * DCT_SCALE_FACTOR)[:, INV_ZIGZAG_TABLE]

    def _kernel_canvases(dense, mvx, mvy, has_coeff, ftype, qidx):
        """Batched decode through the step kernel: dense (B, F, nb, 256)
        stream-layout coefficients, per-block headers (B, F, nb), ftype
        (B, F), qidx (B, F, 3) -> (B, F, chh, cw) u8 canvases."""
        from pfv_tpu.ops.pallas.step_kernel import make_step

        b, f = ftype.shape
        hdr = ((mvy.astype(jnp.int32) + 128)
               | ((mvx.astype(jnp.int32) + 128) << 8)
               | (has_coeff.astype(jnp.int32) << 16))
        hdr = jnp.concatenate(
            [hdr, jnp.full((b, f, 1), 128 | 128 << 8, jnp.int32)], axis=2)
        meta = hdr[:, :, jnp.asarray(src_of_c)]            # (B, F, nbc)
        mult = jnp.asarray(mult_table)[qidx.astype(jnp.int32)].reshape(
            b, f, 3 * 64)
        step = make_step(chh, cw, ly[0] // 16, lc[1] // 16, nb,
                         interpret=mode == "interpret")
        consts = (jnp.asarray(src_of_c), jnp.asarray(INV_ZIGZAG_TABLE,
                                                     jnp.int32))
        coeffs = dense.reshape(b, f, nb * 256)
        ftype = ftype.astype(jnp.int32)

        def body(canvas, i):
            out = step(i[None], coeffs, meta, *consts, mult, ftype, canvas)
            return out, out

        init = jnp.broadcast_to(jnp.asarray(canvas_init), (b, chh, cw))
        _, canvases = jax.lax.scan(body, init,
                                   jnp.arange(f, dtype=jnp.int32))
        return jnp.moveaxis(canvases, 0, 1)

    def _rgba_xla(y, u, v):
        """Unpadded YUV planes -> (F, H, W) u32 RGBA (same float op order
        + saturation as ops.color.yuv_to_rgb)."""
        f = jnp.float32
        u = jnp.repeat(jnp.repeat(u, 2, axis=1), 2, axis=2)[
            :, :height, :width]
        v = jnp.repeat(jnp.repeat(v, 2, axis=1), 2, axis=2)[
            :, :height, :width]
        yf = y.astype(f)
        uf = u.astype(f) - f(128.0)
        vf = v.astype(f) - f(128.0)

        def sat(x):
            return jnp.clip(jnp.trunc(x), 0.0, 255.0).astype(jnp.uint32)

        r = sat(yf + f(1.402) * vf)
        g = sat(yf - f(0.344136) * uf - f(0.714136) * vf)
        b = sat(yf + f(1.772) * uf)
        return r | (g << 8) | (b << 16) | jnp.uint32(0xFF000000)

    def step(carry, x):
        # Branch-free I/P step: the dominant dequant+iDCT work is identical
        # for intra pixels and inter residuals (common.rs:313-325), so both
        # frame types share it and `where` picks the reconstruction — no
        # lax.cond, which keeps the step vmap-able across streams.
        coeffs, mvx, mvy, has_coeff, ftype, qidx = x
        is_intra = ftype == 1
        qt_all = jnp.asarray(qtables)  # numpy -> program constant
        out = []
        for i, (name, sl, shape, (by, bx)) in enumerate(plane_meta):
            ref = carry[i]
            q = qt_all[qidx[i]]
            c = coeffs[sl].reshape(-1, 4, 64)
            res = decode_blocks(c, q)  # intra pixels / inter residuals
            pred = gather_predictions(
                ref, by, bx, mvy[sl].astype(jnp.int32),
                mvx[sl].astype(jnp.int32),
            )
            inter = jnp.where(
                has_coeff[sl].astype(bool)[:, None, None],
                apply_residuals(res, pred),
                pred,
            )
            blocks = jnp.where(is_intra, res, inter)
            out.append(blocks_to_plane(blocks, *shape))
        out = tuple(out)
        return out, out

    def decode_yuv_impl_gather(coeffs, mvx, mvy, has_coeff, ftype, qidx):
        init = (
            jnp.zeros(ly, dtype=jnp.uint8),
            jnp.full(lc, 128, dtype=jnp.uint8),
            jnp.full(lc, 128, dtype=jnp.uint8),
        )
        _, (ys, us, vs) = jax.lax.scan(
            step, init, (coeffs, mvx, mvy, has_coeff, ftype, qidx)
        )
        return (
            ys[:, :height, :width],
            us[:, : height // 2, : width // 2],
            vs[:, : height // 2, : width // 2],
        )

    def decode_yuv_impl(coeffs, mvx, mvy, has_coeff, ftype, qidx):
        """(F, nb, 256) i16 stream-layout dense + headers -> unpadded
        (F,H,W), (F,H/2,W/2) x2 u8 through this decoder's step."""
        if use_kernel:
            canvases = _kernel_canvases(coeffs[None], mvx[None], mvy[None],
                                        has_coeff[None], ftype[None],
                                        qidx[None])
            return _slice_yuv(canvases[0])
        if mode == "gather":
            return decode_yuv_impl_gather(
                coeffs, mvx, mvy, has_coeff, ftype, qidx
            )
        return decode_yuv_impl_mxu(coeffs, mvx, mvy, has_coeff, ftype, qidx)

    def to_rgb_impl(y, u, v):
        """Unpadded device YUV -> (F, H, W, 3) uint8 RGB (batched over F)."""
        u = jnp.repeat(jnp.repeat(u, 2, axis=1), 2, axis=2)[:, :height, :width]
        v = jnp.repeat(jnp.repeat(v, 2, axis=1), 2, axis=2)[:, :height, :width]
        return yuv_to_rgb(y, u, v)

    def decode_rgb_impl(*args):
        return to_rgb_impl(*decode_yuv_impl(*args))

    def _densify(idx, val, n_frames):
        # Materialize dense coefficients on device from (flat idx, value)
        # pairs; padding entries point one past the end (sacrificial slot).
        total = n_frames * nb * 256
        buf = jnp.zeros((total + 1,), jnp.int16)
        buf = buf.at[idx].set(val, indices_are_sorted=True)
        return buf[:total].reshape(n_frames, nb, 256)

    def decode_yuv_sparse_impl(idx, val, mvx, mvy, has_coeff, ftype, qidx):
        dense = _densify(idx, val, mvx.shape[0])
        return decode_yuv_impl(dense, mvx, mvy, has_coeff, ftype, qidx)

    def decode_rgb_sparse_impl(*args):
        # one fused program: scatter + scan + RGB
        return to_rgb_impl(*decode_yuv_sparse_impl(*args))

    _chk_sizes = (height * width, (height // 2) * (width // 2),
                  (height // 2) * (width // 2))

    def _checksums(planes):
        cols = []
        for p, n in zip(planes, _chk_sizes):
            flat = p.reshape(p.shape[0], -1).astype(jnp.uint32)
            wgt = (np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
                   + np.uint32(1))
            cols.append(jnp.sum(flat * wgt, axis=1, dtype=jnp.uint32))
        return jnp.stack(cols, axis=1)

    def decode_checksums_sparse_impl(*args):
        return _checksums(decode_yuv_sparse_impl(*args))

    def _unpack_meta(meta):
        # meta: one uint16 buffer = [bh(F*B) | ftype(F) | qidx(F*3)] —
        # one transfer instead of five. bh packs each block header as
        # (mvx & 127) | (mvy & 127) << 7 | hc << 14, the exact form the
        # native demux emits; typed u16 so the device unpack is one
        # vectorized widening convert.
        f = meta.shape[0] // (nb + 4)
        fb = f * nb
        bh = meta[:fb].astype(jnp.int32).reshape(f, nb)
        # sign-extend the 7-bit two's-complement motion lanes
        mvx = ((bh & 127) ^ 64) - 64
        mvy = (((bh >> 7) & 127) ^ 64) - 64
        hc = (bh >> 14).astype(jnp.uint8)
        ftype = meta[fb : fb + f].astype(jnp.int32)
        qidx = meta[fb + f :].astype(jnp.int32).reshape(f, 3)
        return mvx, mvy, hc, ftype, qidx

    def _densify_units(deltas, vals, n_frames):
        # split unit streams (u16 deltas, i8 vals) -> dense coefficients:
        # inclusive cumsum reconstructs flat positions; scatter-ADD sums a
        # position's units (|v| > 127 spans several same-position units;
        # zero-value bookkeeping units — escapes, tails, padding — are
        # no-ops). The chain parks at `total`, the sacrificial slot.
        total = n_frames * nb * 256
        pos = jnp.cumsum(deltas.astype(jnp.int32))
        buf = jnp.zeros((total + 1,), jnp.int16)
        buf = buf.at[pos].add(vals.astype(jnp.int16), indices_are_sorted=True)
        return buf[:total].reshape(n_frames, nb, 256)

    def _product(yuv, want):
        if want == "rgb":
            return to_rgb_impl(*yuv)
        if want == "rgba":
            return _rgba_xla(*yuv)
        if want == "checksums":
            return _checksums(yuv)
        return yuv

    def _packed_impl(deltas, vals, meta, want):
        mvx, mvy, hc, ftype, qidx = _unpack_meta(meta)
        f = mvx.shape[0]
        dense = _densify_units(deltas, vals, f)
        return _product(decode_yuv_impl(dense, mvx, mvy, hc, ftype, qidx),
                        want)

    # ---- GOP-concurrent form ------------------------------------------------
    # With a uniform keyframe interval L, frame-major layout IS (G, L, ...)
    # — the reshape is free, the demux's parking slot (F*span) falls in the
    # zero-value pad-frame region, and pad frames decode as all-skip
    # P-frames that are sliced off. The G GOP chains then decode in
    # lockstep: scan length L instead of F, G-wide steps (the step kernel's
    # batch axis, or a vmapped XLA scan).
    def _gops_impl(deltas, vals, meta, g, l, want):
        mvx, mvy, hc, ftype, qidx = _unpack_meta(meta)
        f = mvx.shape[0]
        pad = g * l - f

        def padf(a, fill):
            if pad:
                a = jnp.concatenate(
                    [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
            return a.reshape((g, l) + a.shape[1:])

        args = (padf(mvx, 0), padf(mvy, 0), padf(hc, 0), padf(ftype, 2),
                padf(qidx, 0))

        def unstack(p):
            return p.reshape((g * l,) + p.shape[2:])[:f]

        dense = _densify_units(deltas, vals, g * l).reshape(g, l, nb, 256)
        if use_kernel:
            canvases = unstack(_kernel_canvases(dense, *args))
            return _product(_slice_yuv(canvases), want)
        out = jax.vmap(decode_yuv_impl)(dense, *args)
        return _product(tuple(unstack(p) for p in out), want)

    @lru_cache(maxsize=8)
    def _gops_jit(g, l, want):
        return jax.jit(
            lambda deltas, vals, meta: _gops_impl(deltas, vals, meta, g, l,
                                                  want)
        )

    def decode_packed_gops(deltas, vals, meta, g, l, want="rgb"):
        return _gops_jit(g, l, want)(deltas, vals, meta)

    def packed(want):
        return jax.jit(lambda d, v, m: _packed_impl(d, v, m, want))

    decode_yuv = jax.jit(decode_yuv_impl)
    to_rgb = jax.jit(to_rgb_impl)

    def decode_rgb(*args):
        return to_rgb(*decode_yuv(*args))

    return VideoDecoder(
        decode_rgb,
        decode_yuv,
        decode_rgb_impl,
        decode_yuv_impl,
        jax.jit(decode_rgb_sparse_impl),
        jax.jit(decode_yuv_sparse_impl),
        decode_rgb_sparse_impl,
        decode_yuv_sparse_impl,
        jax.jit(decode_checksums_sparse_impl),
        packed("rgb"),
        packed("yuv"),
        packed("checksums"),
        packed("rgba"),
        decode_packed_gops,
    )


def get_decoder(width: int, height: int, qtables: np.ndarray,
                mode: str = "mxu") -> VideoDecoder:
    """VideoDecoder (jitted + raw impls) for a video geometry and step mode
    ("kernel", "interpret", "mxu" or "gather"; see _make_decoder)."""
    qt = np.ascontiguousarray(qtables, dtype=np.int32)
    return _make_decoder(width, height, qt.tobytes(), qt.shape[0], mode)


def _mc_mode(info: dict) -> str:
    """Pick the XLA MC formulation from the demux's max-|mv| report."""
    return "mxu" if info.get("mv_absmax", 127) <= 16 else "gather"


def use_step_kernel(platform: str) -> bool:
    """The one gate for the fused step kernel: it runs on a GPU (where it
    is the fastest decode measured, PERF.md); every other platform takes
    the XLA steps."""
    return platform == "gpu"


def step_mode() -> str | None:
    """"kernel", "interpret" or None (XLA steps) for this process.

    PFV_STEP is the A/B switch: "0" forces the XLA steps, "1" the compiled
    kernel, "interpret" the kernel in the Pallas interpreter (tests on
    the CPU); unset, the platform decides (use_step_kernel)."""
    env = os.environ.get("PFV_STEP", "auto")
    if env == "0":
        return None
    if env == "1":
        return "kernel"
    if env == "interpret":
        return "interpret"
    return "kernel" if use_step_kernel(jax.devices()[0].platform) else None


# Frames of at most this many blocks decode GOP-concurrently. On the H100
# the GOP form cut the sd corpus's (1152 blocks) device time from 3.7-4.2
# to 2.4-2.8 ms per clip (PERF.md); 1080p frames (12240 blocks) already
# fill the card with one frame.
_GOP_CONCURRENT_MAX_BLOCKS = 4096


def _gop_shape(ftype: np.ndarray,
               total_blocks: int) -> tuple[int, int] | None:
    """(n_gops, gop_len) when the stream has a uniform keyframe interval
    and small-enough frames to benefit from GOP-concurrent decode, else
    None. Uniform structure makes the (G, L) regrouping a free reshape of
    the frame-major dense layout (no index rewrite, no output stitch)."""
    ftype = np.asarray(ftype).reshape(-1)
    f = ftype.shape[0]
    starts = np.flatnonzero(ftype == 1)
    if starts.size < 2 or starts[0] != 0:
        return None
    l = int(starts[1])
    if not np.array_equal(starts, np.arange(0, f, l, dtype=starts.dtype)):
        return None
    if total_blocks > _GOP_CONCURRENT_MAX_BLOCKS:
        return None
    g = -(-f // l)
    if g * l * total_blocks * 256 >= 2**31:
        return None
    return g, l


_NNZ_BUCKET = 1 << 16

_meta_tls = threading.local()


def _meta_scratch_buf(n: int) -> np.ndarray:
    """Grow-only per-thread meta staging buffer (thread-local so a loader
    prefetch thread and a direct decode call cannot corrupt each other)."""
    buf = getattr(_meta_tls, "buf", None)
    if buf is None or buf.size < n:
        buf = _meta_tls.buf = np.empty(n, dtype=np.uint16)
    return buf[:n]


def demux_packed_host(data: bytes, num_threads: int = 0,
                      copy: bool = False, mode: str | None = None):
    """Host side of the packed fast path: parse + entropy-decode `data`
    into (info, (deltas, vals, meta)) WITHOUT touching the device.

    mode forces a step ("kernel", "interpret", "mxu", "gather"); by
    default step_mode() decides, and the XLA paths pick mxu/gather from
    the stream's motion range. info["decode_mode"] records the choice and info["gop_shape"]
    the GOP-concurrent form (or None).

    The multi-stream/multi-device layers call this per stream and stack
    the results, so the sharded decode runs the identical programs per
    shard. copy=True materializes private copies (the default arrays
    alias native scratch reused by the NEXT demux call).
    """
    hdr, _ = runtime.parse_header(data)
    w, h = hdr["width"], hdr["height"]
    if mode is None:
        mode = step_mode()
    info, deltas, vals, bh, ftype, qidx = runtime.demux_file_sparse_packed(
        data, num_threads, pad_to_multiple=_NNZ_BUCKET,
        reuse_scratch=not copy,
    )
    if mode is None:
        mode = _mc_mode(info)
    elif mode == "mxu" and _mc_mode(info) != "mxu":
        raise ValueError("stream has |mv| > 16: the mxu step cannot decode it")
    info["decode_mode"] = mode
    info["gop_shape"] = _gop_shape(ftype, info["total_blocks"])

    n = bh.size + ftype.size + qidx.size
    meta = _meta_scratch_buf(n)
    meta[: bh.size] = bh.ravel()
    meta[bh.size : bh.size + ftype.size] = ftype
    meta[bh.size + ftype.size :] = qidx.ravel()
    if copy:
        return info, (deltas.copy(), vals.copy(), meta.copy())
    return info, (deltas, vals, meta)


def _demux_packed_to_device(data: bytes, num_threads: int,
                            mode: str | None = None):
    """Sparse demux + upload (3 transfers: u16 position deltas, i8 values,
    packed meta — 3 wire bytes per coefficient unit); the unit count is
    padded to a bucket size to bound recompiles.

    Padding units are zero (delta 0, value 0): the delta chain is parked
    at the densify scatter's sacrificial slot by the demux, so they add 0
    there. Host buffers are module-level scratch, reused across calls.
    """
    info, arrs = demux_packed_host(data, num_threads, mode=mode)
    # jnp.asarray may alias host memory on the CPU backend, which would
    # extend the scratch buffers' lifetime past the next demux call
    return info, tuple(jnp.array(a, copy=True) for a in arrs)


def decode_packed(info: dict, args, want: str = "rgb"):
    """Decode an uploaded packed demux (`_demux_packed_to_device`) to the
    product `want` ("yuv", "rgb", "rgba" or "checksums") on the path the
    demux chose."""
    dec = get_decoder(info["width"], info["height"], info["qtables"],
                      info["decode_mode"])
    if info["gop_shape"] is not None:
        g, l = info["gop_shape"]
        return dec.decode_packed_gops(*args, g, l, want)
    return {"yuv": dec.decode_yuv_packed, "rgb": dec.decode_rgb_packed,
            "rgba": dec.decode_rgba_packed,
            "checksums": dec.decode_checksums_packed}[want](*args)


def probe_decode_path(data: bytes, num_threads: int = 0) -> dict:
    """Host-side only: report which decode path the dataloader entry
    points would take for `data` — {"decode_mode", "gop_shape"} — without
    touching the device. Benchmarks label measurements with it."""
    info, _ = demux_packed_host(data, num_threads, copy=True)
    gs = info["gop_shape"]
    return {"decode_mode": info["decode_mode"],
            "gop_shape": None if gs is None else list(gs)}


def decode_video_rgb(data: bytes, num_threads: int = 0) -> jnp.ndarray:
    """Decode a whole .pfv byte stream to a (F, H, W, 3) uint8 RGB tensor.

    Sparse fast path: host entropy demux to split (delta, value) unit
    streams + one packed header buffer (3 uploads, ~3 bytes per
    coefficient), then device scatter + decode + RGB in one fused
    program. The result stays on the device — np.asarray() to fetch.
    """
    return decode_packed(*_demux_packed_to_device(data, num_threads), "rgb")


def decode_video_rgba(data: bytes, num_threads: int = 0) -> jnp.ndarray:
    """Decode a whole .pfv byte stream to a (F, H, W) uint32 packed-RGBA
    tensor (little-endian byte order R, G, B, A=255 — view the fetched
    buffer as (F, H, W, 4) u8 for free with `rgba_view`)."""
    return decode_packed(*_demux_packed_to_device(data, num_threads), "rgba")


def rgba_view(rgba: np.ndarray) -> np.ndarray:
    """(F, H, W) u32 packed RGBA (host numpy) -> zero-copy
    (F, H, W, 4) u8 channel view."""
    return rgba.view(np.uint8).reshape(rgba.shape + (4,))


def decode_video_yuv(data: bytes, num_threads: int = 0):
    """Decode a whole .pfv byte stream to unpadded device YUV tensors."""
    return decode_packed(*_demux_packed_to_device(data, num_threads), "yuv")


def decode_video_rgb_chunks(
    data: bytes,
    max_frames_per_chunk: int = 512,
    num_threads: int = 0,
):
    """Decode an arbitrarily long .pfv stream as a list of RGB chunks.

    Splits at keyframe boundaries (GOPs are self-contained), so each chunk
    decodes independently — this removes the int32 flat-index limit of
    decode_video_rgb and bounds per-chunk HBM. Chunk lengths are padded to
    `max_frames_per_chunk` (as all-skip frames, trimmed from the output) so
    every chunk reuses one compiled program.

    Yields (start_frame, (F_chunk, H, W, 3) device uint8) tuples.
    """
    info, idx, val, mvx, mvy, has_coeff, ftype, qidx = runtime.demux_file_sparse(
        data, num_threads
    )
    f, nb = mvx.shape
    per_frame = nb * 256
    starts = np.flatnonzero(ftype == 1)
    if starts.size == 0 or starts[0] != 0:
        raise ValueError("stream must start with an I-frame")

    # greedy chunking: as many whole GOPs as fit under the frame cap
    bounds = [0]
    for i, s in enumerate(starts):
        gop_end = int(starts[i + 1]) if i + 1 < len(starts) else f
        if gop_end - bounds[-1] > max_frames_per_chunk and int(s) > bounds[-1]:
            bounds.append(int(s))
        if gop_end - bounds[-1] > max_frames_per_chunk:
            raise ValueError(
                f"a single GOP ({gop_end - bounds[-1]} frames) exceeds "
                f"max_frames_per_chunk={max_frames_per_chunk}"
            )
    bounds.append(f)

    dec = get_decoder(info["width"], info["height"], info["qtables"],
                      _mc_mode(info))
    cap_len = max_frames_per_chunk
    frame_of = idx // per_frame

    for a, b in zip(bounds, bounds[1:]):
        n = b - a
        lo, hi = np.searchsorted(frame_of, [a, b])
        idx_c = (idx[lo:hi] - a * per_frame).astype(np.int32)
        val_c = val[lo:hi]
        pad = ((idx_c.shape[0] + _NNZ_BUCKET - 1) // _NNZ_BUCKET) * _NNZ_BUCKET
        idx_p = np.full(pad, cap_len * per_frame, dtype=np.int32)
        val_p = np.zeros(pad, dtype=np.int16)
        idx_p[: idx_c.shape[0]] = idx_c
        val_p[: val_c.shape[0]] = val_c

        def pad_f(arr, fill):
            out = np.full((cap_len,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[:n] = arr[a:b]
            return out

        def pad_f2_qidx(q):
            prows = q[ftype == 2]
            fill = prows[0] if prows.shape[0] else np.array([2, 3, 3], q.dtype)
            out = np.broadcast_to(fill, (cap_len, 3)).astype(np.int32).copy()
            out[:n] = q[a:b]
            return out

        args = (
            jnp.asarray(idx_p),
            jnp.asarray(val_p),
            jnp.asarray(pad_f(mvx, 0)),
            jnp.asarray(pad_f(mvy, 0)),
            jnp.asarray(pad_f(has_coeff, 0)),  # padding: all-skip P frames
            jnp.asarray(pad_f(ftype.astype(np.int32), 2)),
            # pad-frame q indices repeat the P-frame pattern (all-skip
            # pads never read their q tables)
            jnp.asarray(pad_f2_qidx(qidx)),
        )
        yield a, dec.decode_rgb_sparse(*args)[:n]


def plane_checksums(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Position-weighted uint32 checksums, (F, 3): one per plane per frame.

    Used to validate device decodes without bulk device->host transfers.
    numpy reference implementation; the device twin is
    `decode_video_checksums`.
    """
    out = np.empty((y.shape[0], 3), dtype=np.uint32)
    for i, p in enumerate((y, u, v)):
        flat = p.reshape(p.shape[0], -1).astype(np.uint32)
        n = flat.shape[1]
        w = np.arange(n, dtype=np.uint32) * np.uint32(2654435761) + np.uint32(1)
        out[:, i] = (flat * w).sum(axis=1, dtype=np.uint32)
    return out


def decode_video_checksums(data: bytes, num_threads: int = 0) -> np.ndarray:
    """Decode on device and return only (F, 3) uint32 plane checksums.

    One fused program (scatter + decode + checksum); the only device->host
    traffic is the checksum matrix.
    """
    return np.asarray(decode_packed(
        *_demux_packed_to_device(data, num_threads), "checksums"))
