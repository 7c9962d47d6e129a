"""Multi-stream decode sharded over a device mesh.

Scaling story (SURVEY.md §2): PFV streams/GOPs are mutually independent, so
the natural multi-chip mapping is data parallelism over a `streams` mesh
axis — placement-only sharding; frames within a stream stay
sequential in the on-device `lax.scan`. A `psum` over the mesh aggregates
global statistics (the only collective the workload needs).

All streams in a batch must share geometry (width/height/frame count) —
stack heterogeneous videos into separate batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pfv_tpu import runtime
from pfv_tpu.dataloader import get_decoder


def make_stream_mesh(n_devices: int | None = None, axis: str = "streams") -> Mesh:
    """A 1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def stack_streams(datas: list[bytes], num_threads: int = 0):
    """Demux S same-geometry .pfv byte streams into stacked (S, ...) tensors."""
    infos, parts = [], []
    for d in datas:
        info, coeffs, mvx, mvy, has_coeff, ftype, qidx = runtime.demux_file(
            d, num_threads
        )
        infos.append(info)
        parts.append((coeffs, mvx, mvy, has_coeff,
                      ftype.astype(np.int32), qidx.astype(np.int32)))
    w, h = infos[0]["width"], infos[0]["height"]
    for i in infos[1:]:
        if (i["width"], i["height"]) != (w, h):
            raise ValueError("all streams in a batch must share geometry")
        if not np.array_equal(i["qtables"], infos[0]["qtables"]):
            raise ValueError("all streams in a batch must share q-tables")
    stacked = tuple(np.stack([p[i] for p in parts]) for i in range(6))
    return infos[0], stacked


def make_sharded_decoder(
    mesh: Mesh, width: int, height: int, qtables: np.ndarray, axis: str = "streams"
):
    """Jitted sharded multi-stream decoder.

    Returns fn(stacked (S, ...) tensors) -> ((S, F, H, W, 3) u8 RGB sharded
    over `axis`, global mean-luma scalar aggregated with psum).
    S must be divisible by the mesh axis size.
    """
    dec = get_decoder(width, height, qtables)

    def local_decode(coeffs, mvx, mvy, has_coeff, ftype, qidx):
        rgb = jax.vmap(dec.decode_rgb_impl)(coeffs, mvx, mvy, has_coeff, ftype, qidx)
        # global statistic over the mesh: mean luma proxy (one collective)
        local_sum = jnp.sum(rgb.astype(jnp.float32)) / rgb.size
        global_mean = jax.lax.psum(local_sum, axis) / jax.lax.psum(
            jnp.ones(()), axis
        )
        return rgb, global_mean

    # check_vma=False: the scan carry starts from mesh-invariant constants
    # (zero/neutral planes) that become per-shard varying on the first frame;
    # everything here is per-shard data parallel, so the VMA check is moot.
    sharded = jax.shard_map(
        local_decode,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def decode_stream_batch_rgb(
    datas: list[bytes],
    mesh: Mesh | None = None,
    num_threads: int = 0,
):
    """Demux + decode a batch of same-geometry streams across the mesh.

    Returns ((S, F, H, W, 3) uint8 RGB, global mean luma) — RGB stays
    sharded across devices (one shard per device's memory).
    """
    if mesh is None:
        mesh = make_stream_mesh()
    info, stacked = stack_streams(datas, num_threads)
    axis = mesh.axis_names[0]
    spec = NamedSharding(mesh, P(axis))
    dev_args = tuple(jax.device_put(a, spec) for a in stacked)
    fn = make_sharded_decoder(mesh, info["width"], info["height"], info["qtables"], axis)
    return fn(*dev_args)


# ---------------------------------------------------------------------------
# Fast-path sharding: the sharded decode runs the SAME packed demux layout
# and step (kernel or XLA) as the single-device path: shard_map runs one
# program per device.
# ---------------------------------------------------------------------------


def stack_streams_packed(datas: list[bytes], num_threads: int = 0):
    """Demux S same-geometry .pfv streams through the dataloader's own
    fast-path demux (`demux_packed_host`) — (deltas, vals, meta) — and
    stack to (S, ...) host arrays.

    Variable-length unit streams are zero-padded to the batch max: a zero
    unit is inert by construction (delta 0 stays parked at the densify
    scatter's sacrificial slot and adds value 0).

    Returns (info, stacked): info is stream 0's, after asserting every
    stream selects the same geometry, q-tables, and decode path.
    """
    from pfv_tpu.dataloader import demux_packed_host

    infos, parts = [], []
    for d in datas:
        # copy=True: the demux reuses native scratch across calls
        info, arrs = demux_packed_host(d, num_threads, copy=True)
        infos.append(info)
        parts.append(arrs)
    i0 = infos[0]
    for i in infos[1:]:
        if (i["width"], i["height"]) != (i0["width"], i0["height"]):
            raise ValueError("all streams in a batch must share geometry")
        if not np.array_equal(i["qtables"], i0["qtables"]):
            raise ValueError("all streams in a batch must share q-tables")
        if (i["decode_mode"], i["gop_shape"]) != (i0["decode_mode"],
                                                   i0["gop_shape"]):
            raise ValueError(
                "all streams in a batch must select the same decode path; "
                f"got {i['decode_mode']} vs {i0['decode_mode']}")

    def padto(a, n):
        if a.shape[0] == n:
            return a
        out = np.zeros((n,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    n0 = max(p[0].shape[0] for p in parts)
    n1 = max(p[1].shape[0] for p in parts)
    stacked = (
        np.stack([padto(p[0], n0) for p in parts]),
        np.stack([padto(p[1], n1) for p in parts]),
        np.stack([p[2] for p in parts]),
    )
    return i0, stacked


def make_sharded_packed_decoder(mesh: Mesh, info: dict,
                                axis: str = "streams", want: str = "yuv"):
    """Jitted sharded decoder over the FAST packed path.

    Each device decodes its local streams with the identical program the
    single-device path runs — the step kernel or the XLA step, per frame
    or GOP-concurrent — plus a psum'd global mean-luma statistic.
    Streams per device > 1 unroll as
    a static loop inside the per-device program.

    Returns fn(stacked) -> ((S, ...) product sharded over `axis`, global
    mean luma). want: "yuv" -> (y, u, v) planes; "rgb"/"rgba" -> one array.
    """
    from pfv_tpu.dataloader import get_decoder

    dec = get_decoder(info["width"], info["height"], info["qtables"],
                      info["decode_mode"])
    gs = info["gop_shape"]
    fn1 = {"yuv": dec.decode_yuv_packed, "rgb": dec.decode_rgb_packed,
           "rgba": dec.decode_rgba_packed}[want]

    def one(a, b, m):
        if gs is not None:
            return dec.decode_packed_gops(a, b, m, gs[0], gs[1], want)
        return fn1(a, b, m)

    def local_decode(a, b, m):
        outs = [one(a[i], b[i], m[i]) for i in range(a.shape[0])]
        if want == "yuv":
            res = tuple(jnp.stack([o[j] for o in outs]) for j in range(3))
            luma = res[0]
        else:
            res = jnp.stack(outs)
            luma = res
        local_sum = jnp.sum(luma.astype(jnp.float32)) / luma.size
        gmean = jax.lax.psum(local_sum, axis) / jax.lax.psum(
            jnp.ones(()), axis)
        return res, gmean

    out_spec = ((P(axis), P(axis), P(axis)) if want == "yuv" else P(axis))
    sharded = jax.shard_map(
        local_decode, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(out_spec, P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def decode_stream_batch_packed(
    datas: list[bytes],
    mesh: Mesh | None = None,
    num_threads: int = 0,
    want: str = "yuv",
):
    """Batch-decode same-geometry streams across the mesh via the fast
    packed path (see make_sharded_packed_decoder).

    Returns ((S, F, ...) product sharded over the mesh, global mean luma).
    S must be divisible by the mesh axis size.
    """
    if mesh is None:
        mesh = make_stream_mesh()
    axis = mesh.axis_names[0]
    if len(datas) % mesh.shape[axis] != 0:
        raise ValueError(
            f"stream count {len(datas)} not divisible by mesh axis "
            f"{axis}={mesh.shape[axis]}")
    info, stacked = stack_streams_packed(datas, num_threads)
    spec = NamedSharding(mesh, P(axis))
    dev_args = tuple(jax.device_put(a, spec) for a in stacked)
    fn = make_sharded_packed_decoder(mesh, info, axis, want)
    return fn(*dev_args)
