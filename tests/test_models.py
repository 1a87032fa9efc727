"""Similarity (vidstab) and deshake model family tests."""

import os
import tempfile

import numpy as np
import pytest

import cv2
import jax
import jax.numpy as jnp

from video_annotator_tpu.ops.affine import (
    compose_similarity,
    fit_similarity,
    invert_similarity,
    warp_similarity,
)
from video_annotator_tpu.ops.phasecorr import phase_correlate
from video_annotator_tpu.pipeline.render import RenderOptions, render
from video_annotator_tpu.io.video import open_reader
from video_annotator_tpu.camera import CameraPreset


def _textured(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h // 8, w // 8)).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.float32)


def test_fit_similarity_exact():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 500, (100, 2)).astype(np.float32)
    ang, s, dx, dy = 0.03, 1.02, 4.5, -2.5
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    c = (s * (p @ R.T) + [dx, dy]).astype(np.float32)
    params, inliers = fit_similarity(
        jnp.asarray(p), jnp.asarray(c), jnp.ones(100, bool)
    )
    params = np.asarray(params)
    assert int(inliers) == 100
    np.testing.assert_allclose(params, [dx, dy, ang, np.log(s)], atol=1e-3)


def test_fit_similarity_with_outliers():
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 500, (100, 2)).astype(np.float32)
    c = (p + [7.0, -3.0]).astype(np.float32)
    out = rng.random(100) < 0.25
    c[out] += rng.uniform(-80, 80, (int(out.sum()), 2))
    params, inliers = fit_similarity(
        jnp.asarray(p), jnp.asarray(c), jnp.ones(100, bool)
    )
    params = np.asarray(params)
    assert int(inliers) > 60
    np.testing.assert_allclose(params[:2], [7.0, -3.0], atol=0.25)


def test_compose_invert_similarity():
    a = jnp.asarray([3.0, -2.0, 0.1, 0.05])
    ident = np.asarray(compose_similarity(a, invert_similarity(a)))
    np.testing.assert_allclose(ident, [0, 0, 0, 0], atol=1e-5)


def test_warp_similarity_matches_cv2():
    img = _textured(240, 320, seed=2)
    params = jnp.asarray([5.0, -3.0, 0.02, 0.01])
    ours = np.asarray(warp_similarity(jnp.asarray(img), params))
    s = np.exp(0.01)
    M = np.array(
        [
            [s * np.cos(0.02), -s * np.sin(0.02), 5.0],
            [s * np.sin(0.02), s * np.cos(0.02), -3.0],
        ]
    )
    ref = cv2.warpAffine(
        img, M, (320, 240),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT,
    )
    interior = np.s_[20:-20, 20:-20]
    err = np.abs(ours[interior] - ref[interior])
    assert np.median(err) < 0.5


def test_phase_correlate_recovers_shift():
    img = _textured(256, 256, seed=3)
    d_true = (6.0, -9.0)
    M = np.float32([[1, 0, d_true[0]], [0, 1, d_true[1]]])
    img2 = cv2.warpAffine(img, M, (256, 256))
    # img2(x) = img(x - d): phase_correlate(img2, img) finds d
    d, peak = phase_correlate(jnp.asarray(img2), jnp.asarray(img))
    np.testing.assert_allclose(np.asarray(d), d_true, atol=0.2)


def test_phase_correlate_periodic_texture():
    """Narrowband (sum-of-sinusoids) content must not corrupt the peak.

    Fully whitened phase correlation measured 1.9 px median / 4 px max
    error on this texture (the synthetic world texture's spectral shape,
    ``io/synthetic.py``); the regularized spectral weight must hold
    sub-0.1 px. Guards the deshake family's analysis pass.
    """
    h, w = 240, 320
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (
        128
        + 60
        * (
            0.35 * np.sin(xs * 0.21) * np.sin(ys * 0.23)
            + 0.25 * np.sin(xs * 0.57 + 1.3) * np.cos(ys * 0.49)
            + 0.2 * np.sin(xs * 0.09 - ys * 0.11)
        )
    ).astype(np.float32)
    rng = np.random.default_rng(0)
    for _ in range(5):
        d_true = rng.uniform(-4, 4, 2)
        M = np.float32([[1, 0, d_true[0]], [0, 1, d_true[1]]])
        img2 = cv2.warpAffine(
            img, M, (w, h),
            flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT,
        )
        d, _ = phase_correlate(jnp.asarray(img2), jnp.asarray(img))
        np.testing.assert_allclose(np.asarray(d), d_true, atol=0.1)


def test_phase_correlate_confidence_separates_degenerate_pairs():
    """Normalized confidence: shifted pairs >> the deshake gate (1.5) >> cuts.

    The confidence is PSR / sqrt(2 ln N) — size-normalized so one
    threshold works from the analysis-scale levels up to 4K (a raw PSR
    gate false-rejects small frames and false-accepts large ones; see
    ops/phasecorr.py for the measured distributions).
    """
    h, w = 240, 320
    rng = np.random.default_rng(3)
    a = cv2.GaussianBlur(
        rng.uniform(0, 255, (h, w)).astype(np.float32), (0, 0), 1.5
    )
    b = cv2.GaussianBlur(
        rng.uniform(0, 255, (h, w)).astype(np.float32), (0, 0), 1.5
    )
    M = np.float32([[1, 0, 3.0], [0, 1, -2.0]])
    a_sh = cv2.warpAffine(a, M, (w, h), borderMode=cv2.BORDER_REFLECT)
    _, conf_good = phase_correlate(jnp.asarray(a_sh), jnp.asarray(a))
    _, conf_cut = phase_correlate(jnp.asarray(b), jnp.asarray(a))
    flat_a = 128 + rng.normal(0, 1, (h, w)).astype(np.float32)
    flat_b = 128 + rng.normal(0, 1, (h, w)).astype(np.float32)
    _, conf_flat = phase_correlate(jnp.asarray(flat_a), jnp.asarray(flat_b))
    assert float(conf_good) > 3.0
    assert float(conf_cut) < 1.4
    assert float(conf_flat) < 0.8


@pytest.mark.parametrize("filt", ["similarity", "deshake"])
def test_2d_families_end_to_end(tmp_path, filt):
    src = "synthetic://shaky?w=256&h=192&n=20&seed=9&shake=0.004&pan=0.0"
    out_shaky = str(tmp_path / "a.y4m")
    out_smooth = str(tmp_path / "b.y4m")
    opts = dict(preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED, filter=filt)
    render(src, out_shaky, RenderOptions(stabilise="none", **opts))
    render(src, out_smooth, RenderOptions(stabilise="smooth", stabilise_radius=7, **opts))

    def motion(path):
        r = open_reader(path)
        prev, diffs = None, []
        for y, _, _ in r:
            cur = y.astype(np.float32)
            if prev is not None:
                c = np.s_[48:144, 64:192]
                diffs.append(np.abs(cur[c] - prev[c]).mean())
            prev = cur
        r.close()
        return np.mean(diffs)

    m_shaky = motion(out_shaky)
    m_smooth = motion(out_smooth)
    # 2D models can't fully cancel rotational fisheye shake, but must help.
    assert m_smooth < m_shaky * 0.9, (filt, m_shaky, m_smooth)


def test_similarity_stabilise_buffer_zooms_out():
    """vidstab's zoom: -buffer — a static trajectory with a 20% buffer
    samples a 1/0.8 scaled grid around the centre (src/render.ts:569-570)."""
    import types

    from video_annotator_tpu.models.similarity import similarity_corrections
    from video_annotator_tpu.pipeline.trajectory import Trajectory

    t = Trajectory(np.zeros((5, 4)), kind="similarity", width=640, height=480)
    opt = types.SimpleNamespace(
        stabilise="smooth", stabilise_radius=30, stabilise_buffer=20.0
    )
    corr = similarity_corrections(t, opt)
    k = 1.0 / 0.8
    # sample(center) == center; sample(center + d) == center + k*d
    cx, cy = (640 - 1) / 2.0, (480 - 1) / 2.0
    dx, dy, ang, ls = corr[2]
    assert abs(ang) < 1e-6
    np.testing.assert_allclose(np.exp(ls), k, rtol=1e-6)
    np.testing.assert_allclose(np.exp(ls) * cx + dx, cx, atol=1e-3)
    np.testing.assert_allclose(np.exp(ls) * cy + dy, cy, atol=1e-3)

    opt0 = types.SimpleNamespace(
        stabilise="smooth", stabilise_radius=30, stabilise_buffer=0.0
    )
    corr0 = similarity_corrections(t, opt0)
    np.testing.assert_allclose(corr0, 0.0, atol=1e-5)


def test_2d_families_analysis_scale_matches_full():
    """--analysis-scale 0.5 trajectories agree with full-res (translations
    re-scaled to full-res pixels at collect time)."""
    from video_annotator_tpu.models.deshake import analyse_deshake
    from video_annotator_tpu.models.similarity import analyse_similarity

    src = "synthetic://?w=384&h=288&n=12&seed=6&shake=0.006"
    full_s = analyse_similarity(src, RenderOptions())
    half_s = analyse_similarity(src, RenderOptions(analysis_scale=0.5))
    assert half_s.params.shape == full_s.params.shape
    # translations within a pixel, angle/log-scale within a few millirad
    np.testing.assert_allclose(
        half_s.params[:, :2], full_s.params[:, :2], atol=1.0
    )
    np.testing.assert_allclose(
        half_s.params[:, 2:], full_s.params[:, 2:], atol=5e-3
    )

    full_d = analyse_deshake(src, RenderOptions())
    half_d = analyse_deshake(src, RenderOptions(analysis_scale=0.5))
    np.testing.assert_allclose(half_d.params, full_d.params, atol=1.5)


def test_deshake_shift_matches_gather_semantics():
    """The axis-wise-take translation warp must equal the original
    per-pixel bilinear_sample formulation (BORDER_CONSTANT zeros for the
    planes, replicate-edge for the blurred background fill) to float
    rounding, at integer, fractional and fully-out-of-frame offsets."""
    import jax
    import jax.numpy as jnp

    from video_annotator_tpu.models.deshake import (
        _gauss_blur,
        warp_frame_deshake,
    )
    from video_annotator_tpu.ops.warp_xla import bilinear_sample

    def oracle_shift(img, off, fill_blur):
        h, w = img.shape
        ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + off[1]
        xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + off[0]
        out = bilinear_sample(img, jnp.stack([xs, ys], axis=-1))
        if fill_blur:
            inside = (
                (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
            ).astype(jnp.float32)
            bg = _gauss_blur(img)
            xc = jnp.clip(xs, 0, w - 1)
            yc = jnp.clip(ys, 0, h - 1)
            bg_s = bilinear_sample(bg, jnp.stack([xc, yc], axis=-1))
            out = inside * out + (1.0 - inside) * bg_s
        return out

    rng = np.random.default_rng(0)
    y = jnp.asarray(np.round(rng.uniform(0, 255, (96, 128))).astype(np.float32))
    u = jnp.asarray(np.round(rng.uniform(0, 255, (48, 64))).astype(np.float32))
    v = jnp.asarray(np.round(rng.uniform(0, 255, (48, 64))).astype(np.float32))
    for off in ([3.7, -2.3], [0.0, 0.0], [-17.5, 11.25], [200.0, -300.0]):
        offj = jnp.asarray(off, jnp.float32)
        wy, wu, wv = warp_frame_deshake(y, u, v, offj)
        np.testing.assert_allclose(
            np.asarray(wy), np.asarray(oracle_shift(y, offj, True)), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(wu),
            np.asarray(oracle_shift(u - 128.0, offj * 0.5, False) + 128.0),
            atol=5e-3,
        )
        np.testing.assert_allclose(
            np.asarray(wv),
            np.asarray(oracle_shift(v - 128.0, offj * 0.5, False) + 128.0),
            atol=5e-3,
        )


def test_similarity_upsample_folds_scale():
    """--upsample with the vidstab family grows the canvas and upscales
    content in the SAME single resample (the reference inserts a scale
    filter before its 2D chain, src/cli.ts:46-51): with stabilise=none
    the output equals a pixel-center bilinear upscale of the input."""
    import subprocess
    import sys

    import cv2

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    dest = os.path.join(tempfile.mkdtemp(), "up.y4m")
    r = subprocess.run(
        [sys.executable, "-m", "video_annotator_tpu", "render",
         "synthetic://shaky?w=192&h=144&n=4", dest,
         "--filter", "vidstab", "--stabilise", "none", "--upsample", "150"],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    d = open(dest, "rb").read()
    hdr = d[: d.index(b"\n")].decode()
    assert "W288 H216" in hdr, hdr
    i = d.index(b"FRAME")
    j = d.index(b"\n", i) + 1
    y_up = np.frombuffer(d[j : j + 288 * 216], np.uint8).reshape(216, 288)

    from video_annotator_tpu.io.video import open_reader

    y0 = next(iter(open_reader("synthetic://shaky?w=192&h=144&n=4")))[0]
    ref = cv2.resize(np.asarray(y0), (288, 216),
                     interpolation=cv2.INTER_LINEAR)
    diff = np.abs(y_up.astype(int) - ref.astype(int))
    assert diff.mean() < 1.5, diff.mean()


def test_deshake_upsample_rejected():
    """Translation-only deshake cannot scale; --upsample must error, not
    silently ignore."""
    from video_annotator_tpu.pipeline.render import RenderOptions, render

    with pytest.raises(ValueError, match="upsample"):
        render("synthetic://shaky?w=96&h=64&n=4", None,
               RenderOptions(filter="deshake", upsample=25.0,
                             stabilise="smooth", stabilise_radius=2))


def test_corrections_empty_trajectory():
    """A trim window selecting no frames must yield empty corrections, not
    a broadcast shape error (reviewed regression; the rotation family has
    always guarded t == 0)."""
    from video_annotator_tpu.models.deshake import deshake_corrections
    from video_annotator_tpu.models.similarity import similarity_corrections
    from video_annotator_tpu.pipeline.trajectory import Trajectory

    opts = RenderOptions(stabilise="smooth", stabilise_radius=30)
    sim = Trajectory(params=np.zeros((0, 4)), kind="similarity", fps=30.0,
                     width=96, height=64, source="x")
    assert similarity_corrections(sim, opts).shape == (0, 4)
    tr = Trajectory(params=np.zeros((0, 2)), kind="translation", fps=30.0,
                    width=96, height=64, source="x")
    assert deshake_corrections(tr, opts).shape == (0, 2)


def test_tracking_gates_inlier_cap():
    """The inlier gate scales DOWN for small inputs but is capped at the
    reference's 40 (FrameSourceWarp.cpp:432) for large ones — 4K footage
    must not demand 80 inliers. Shared helper used by both families."""
    from video_annotator_tpu.pipeline.render import tracking_gates

    _, inliers_4k, _ = tracking_gates(3840)
    _, inliers_hd, _ = tracking_gates(1920)
    _, inliers_sm, _ = tracking_gates(640)
    assert inliers_4k == 40
    assert inliers_hd == 40
    assert 10 <= inliers_sm < 40


def test_warp_frame_deshake_blur_edges_flag():
    """blur_edges is a static jit arg: passing it explicitly must not
    raise TracerBoolConversionError, and False disables the edge fill
    (borders come out empty instead of blurred)."""
    from video_annotator_tpu.models.deshake import warp_frame_deshake

    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.integers(64, 192, (32, 64)).astype(np.float32))
    u = jnp.asarray(rng.integers(64, 192, (16, 32)).astype(np.float32))
    off = jnp.asarray([8.0, 0.0])
    y_fill, _, _ = warp_frame_deshake(y, u, u, off, blur_edges=True)
    y_none, _, _ = warp_frame_deshake(y, u, u, off, blur_edges=False)
    # Shifted-in region identical; revealed band differs (blur vs empty).
    assert np.allclose(np.asarray(y_fill[:, :-9]), np.asarray(y_none[:, :-9]))
    assert np.asarray(y_none[:, -8:]).max() == 0.0
    assert np.asarray(y_fill[:, -8:]).max() > 0.0


def _yuv_batch(b, h, w, seed=0):
    """b smooth uint8 YUV 4:2:0 frames (luma ``_textured``, chroma too)."""
    ys = [_textured(h, w, seed + i).round().astype(np.uint8) for i in range(b)]
    us = [_textured(h // 2, w // 2, 50 + seed + i).round().astype(np.uint8)
          for i in range(b)]
    vs = [_textured(h // 2, w // 2, 90 + seed + i).round().astype(np.uint8)
          for i in range(b)]
    return ys, us, vs


def _within_one(got, want, min_identical=0.99):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= min_identical, (d == 0).mean()


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "lanczos"])
def test_similarity_batch_warp_matches_frames_and_reference(interp):
    """The encode's one-dispatch similarity warp == per-frame
    warp_frame_similarity == the float64 NumPy reference."""
    from video_annotator_tpu.models.similarity import warp_frame_similarity
    from video_annotator_tpu.ops.warp_ref import similarity_yuv420_np
    from video_annotator_tpu.ops.warp_xla import to_uint8
    from video_annotator_tpu.pipeline.render import warp_2d_batch_fn

    h, w, b = 72, 96, 3
    ys, us, vs = _yuv_batch(b, h, w)
    rng = np.random.default_rng(3)
    params = (rng.normal(size=(b, 4)) * [4.0, 4.0, 0.02, 0.02]).astype(
        np.float32)
    outs = warp_2d_batch_fn("similarity", (h, w), (h, w), interp)(
        ys, us, vs, jnp.asarray(params))
    assert len(outs) == b
    for i in range(b):
        one = warp_frame_similarity(
            *(jnp.asarray(p[i], jnp.float32) for p in (ys, us, vs)),
            jnp.asarray(params[i]), interp=interp)
        ref = similarity_yuv420_np(ys[i], us[i], vs[i], params[i],
                                   interp=interp)
        for got, frame, want in zip(outs[i], one, ref):
            assert got.dtype == jnp.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(to_uint8(frame)))
            _within_one(got, want)


@pytest.mark.parametrize("offset", [(3.75, -2.25), (0.0, 0.0),
                                    (-17.5, 11.25), (200.0, -300.0)])
def test_deshake_batch_warp_matches_reference_blur_fill(offset):
    """The encode's one-dispatch deshake warp (blurred-edge fill) against
    the float64 NumPy reference, whose blur is an independent padded
    convolution — the fill region included. Offsets are binary fractions,
    so float32 tap weights are exact and half-level ties round alike."""
    from video_annotator_tpu.ops.warp_ref import deshake_yuv420_np
    from video_annotator_tpu.pipeline.render import warp_2d_batch_fn

    h, w = 72, 96
    ys, us, vs = _yuv_batch(2, h, w, seed=4)
    offs = np.asarray([offset, (-offset[0], offset[1])], np.float32)
    outs = warp_2d_batch_fn("translation", (h, w), (h, w), "bilinear")(
        ys, us, vs, jnp.asarray(offs))
    for i in range(2):
        ref = deshake_yuv420_np(ys[i], us[i], vs[i], offs[i])
        for got, want in zip(outs[i], ref):
            _within_one(got, want)
        xs = np.arange(w) + offs[i][0]
        yy = np.arange(h) + offs[i][1]
        fill = ~(((xs >= 0) & (xs <= w - 1))[None, :]
                 & ((yy >= 0) & (yy <= h - 1))[:, None])
        if fill.any():
            _within_one(np.asarray(outs[i][0])[fill], ref[0][fill])


def test_2d_batch_warp_cuts_odd_inputs_to_even():
    """Odd-sized decoded planes are cut to the even 4:2:0 size inside the
    jitted warp, as the per-frame encode used to do on the host."""
    from video_annotator_tpu.pipeline.render import warp_2d_batch_fn

    ys, us, vs = _yuv_batch(2, 74, 98)
    ys = [y[:73, :97] for y in ys]
    (wy, wu, wv), _ = warp_2d_batch_fn(
        "translation", (72, 96), (72, 96), "bilinear")(
        ys, us, vs, jnp.zeros((2, 2)))
    assert wy.shape == (72, 96) and wu.shape == wv.shape == (36, 48)
    np.testing.assert_array_equal(np.asarray(wy), ys[0][:72, :96])
    with pytest.raises(ValueError, match="kind"):
        warp_2d_batch_fn("so3", (72, 96), (72, 96), "bilinear")


@pytest.mark.parametrize("sigma", [2.0, 8.0])
def test_gauss_blur_reference_matches_scipy(sigma):
    """The reference blur (replicate edges, taps to 3 sigma) is scipy's."""
    from scipy.ndimage import gaussian_filter

    from video_annotator_tpu.ops.warp_ref import gauss_blur_np

    img = _textured(40, 56, seed=7).astype(np.float64)
    want = gaussian_filter(img, sigma, mode="nearest", truncate=3.0)
    np.testing.assert_allclose(gauss_blur_np(img, sigma), want, atol=1e-9)
