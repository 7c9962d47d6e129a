"""Platform plumbing: the step-kernel gate and PFV_STEP, the compile-cache
location, the native library's build key, VideoDataLoader on the kernel
path, and chip_smoke.py's comparison phases at a tiny size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from pfv_tpu import dataloader
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame


def _clip(w, h, f, kf=3, t0=0):
    ys, us, vs = map(
        np.stack, zip(*[synth_yuv_frame(t + t0, w, h) for t in range(f)])
    )
    return encode_video(ys, us, vs, 30, 3, keyframes=kf)


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False),
                                           ("METAL", False)])
def test_step_gate(platform, want):
    assert dataloader.use_step_kernel(platform) is want


@pytest.mark.parametrize("env,want", [("0", None), ("1", "kernel"),
                                      ("interpret", "interpret"),
                                      (None, None)])
def test_step_mode(env, want, monkeypatch):
    # unset, the CPU test platform takes the XLA steps
    if env is None:
        monkeypatch.delenv("PFV_STEP", raising=False)
    else:
        monkeypatch.setenv("PFV_STEP", env)
    assert dataloader.step_mode() == want


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": "/x/y"}])
def test_compile_cache_dir(env):
    import os

    from pfv_tpu import config

    got = config.compile_cache_dir(env)
    if env:
        assert got is None  # JAX reads the variable itself
    else:
        root = os.path.dirname(os.path.dirname(config.__file__))
        assert got == os.path.join(root, ".jax_cache")


def test_native_build_key_names_host(monkeypatch):
    """A library built on another host (or from another source) has
    another name, so it is never loaded here."""
    from pfv_tpu import runtime

    key = runtime._build_key("g++")
    assert runtime._build_key("g++") == key
    assert runtime._so_path().endswith(f"libpfv_bitstream-{key}.so")
    monkeypatch.setattr(runtime.platform, "node", lambda: "another-host")
    assert runtime._build_key("g++") != key


def test_loader_kernel_path(monkeypatch):
    """VideoDataLoader builds its decoder exactly as decode_video_rgb does
    (kernel path, GOP-concurrent form, two geometries)."""
    from pfv_tpu.loader import VideoDataLoader
    from pfv_tpu.utils.timing import equal, reference_products

    monkeypatch.setenv("PFV_STEP", "interpret")
    datas = [_clip(96, 64, 6), _clip(64, 48, 4, kf=8, t0=5)]
    outs = list(VideoDataLoader(datas, prefetch=1))
    assert len(outs) == 2
    for d, out in zip(datas, outs):
        assert equal(out, reference_products(d)["rgb"])
        assert equal(out, np.asarray(dataloader.decode_video_rgb(d)))


def test_chip_smoke_compare_steps():
    import chip_smoke

    from pfv_tpu.utils.timing import reference_products

    data = _clip(64, 48, 4)
    ref = reference_products(data)
    res = chip_smoke.compare_steps(data, ref["yuv"], 1,
                                   modes=("interpret", "mxu", "gather"))
    assert set(res) == {"interpret", "mxu", "gather"}
    for mode, r in res.items():
        assert r["ok"] and r["mode"] == mode
        assert r["e2e_ms"] > 0 and r["device_ms"] > 0


def test_chip_smoke_gop_form(monkeypatch):
    import chip_smoke

    from pfv_tpu.utils.timing import reference_products

    monkeypatch.setenv("PFV_STEP", "interpret")
    data = _clip(64, 48, 6)
    res = chip_smoke.compare_gop_form(data, reference_products(data)["yuv"],
                                      1)
    assert res["on"]["ok"] and res["off"]["ok"]
    assert res["on"]["gop_shape"] == [2, 3] and res["off"]["gop_shape"] is None
    assert dataloader._GOP_CONCURRENT_MAX_BLOCKS == 4096  # restored


def test_time_path_detects_mismatch():
    from pfv_tpu.utils.timing import reference_products, time_path

    data = _clip(64, 48, 3)
    y, u, v = reference_products(data)["yuv"]
    bad = (y ^ 1, u, v)
    assert not time_path(data, "yuv", bad, 1)["ok"]


@pytest.mark.gpu
def test_step_kernel_compiled_on_gpu(gpu_device, monkeypatch):
    """The compiled (not interpreted) kernel on a card: bit-exact."""
    from pfv_tpu.utils.timing import equal, reference_products

    monkeypatch.setenv("PFV_STEP", "1")
    data = _clip(136, 90, 7)
    assert equal(dataloader.decode_video_yuv(data),
                 reference_products(data)["yuv"])
