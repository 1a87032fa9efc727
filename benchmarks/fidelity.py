"""Committed fidelity + latency artifact for BASELINE.json's gate clauses.

BASELINE names two numeric gates: warp fidelity **PSNR >= 45 dB vs the
reference warp** (the cv2.remap oracle — the reference's own warp is
``createMap`` + ``cv::remap INTER_LINEAR``,
``opencv/FrameSourceWarp.cpp:272-312``) and **p50 per-frame warp latency
< 4 ms** on the production batched window. This script measures both on
the device at a realistic correction and writes
``benchmarks/fidelity.json``:

    python benchmarks/fidelity.py [--batch 32] [--dispatches 24]

Latency protocol: the encode loop's unit of work is one
``warp_yuv_batch`` dispatch of ``--batch`` full-YUV frames; each timed
dispatch is individually synced (so a dispatch's wall time includes the
host->device round trip — conservative vs the pipelined two-in-flight
encode loop), and per-frame latency = dispatch wall / batch. p50/p99
are over the timed dispatches. PSNR compares the warp's uint8 output
against cv2.remap on float32 input (float weights, no cv2 fixed-point
quantization) rounded to the same uint8 grid, luma and chroma planes
separately, at a 3-degree correction — the top of the per-frame range a
radius-30 smoother produces on shaky footage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def psnr(a, b, peak=255.0):
    import numpy as np

    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(peak**2 / mse)) if mse > 0 else float("inf")


def _textured(h, w, seed=0):
    """Textured uint8 plane (sinusoids + noise): interpolation error is
    content-dependent, so fidelity is scored on busy content, not flats."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        128
        + 80 * np.sin(xx / 17.0)
        + 40 * np.cos(yy / 11.0)
        + rng.normal(size=(h, w)) * 10
    )
    return np.clip(img, 0, 255).astype(np.uint8)


def run(batch: int, dispatches: int, correction_deg: float) -> dict:
    import cv2
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.ops.warp_xla import _scaled_camera, compute_warp_map
    from video_annotator_tpu.pipeline.render import FrameWarper

    w, h = 3840, 2880
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam)
    oh, ow = warper.out_h, warper.out_w

    # A realistic correction: |rotvec| = correction_deg about a skew axis.
    axis = np.asarray([0.45, 0.65, 0.61])
    rot = so3.exp(jnp.asarray(
        axis / np.linalg.norm(axis) * np.radians(correction_deg), jnp.float32))

    y = _textured(h, w, seed=1)
    u = _textured(h // 2, w // 2, seed=2)
    v = _textured(h // 2, w // 2, seed=3)
    wy, wu, wv = jax.block_until_ready(
        warper.warp_yuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), rot))

    # Oracle: cv2.remap INTER_LINEAR on float input (float weights) with
    # the same map (device-computed coords fetched once), same border
    # semantics (0 luma / 128 chroma), rounded to the same uint8 grid.
    def oracle(plane, o_cam, i_cam, out_size, border):
        coords = np.asarray(jax.jit(
            lambda r: compute_warp_map(o_cam, i_cam, r, out_size)
        )(rot))
        ref = cv2.remap(
            plane.astype(np.float32), coords[..., 0], coords[..., 1],
            cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
            borderValue=border,
        )
        return np.clip(np.round(ref), 0, 255).astype(np.uint8)

    psnr_y = psnr(wy, oracle(y, out_cam, in_cam, (oh, ow), 0.0))
    half_out = _scaled_camera(out_cam, 0.5)
    half_in = _scaled_camera(in_cam, 0.5)
    psnr_u = psnr(wu, oracle(u, half_out, half_in,
                             (oh // 2, ow // 2), 128.0))
    psnr_v = psnr(wv, oracle(v, half_out, half_in,
                             (oh // 2, ow // 2), 128.0))

    # --- latency: the production batched window, per-dispatch synced ----
    rng = np.random.default_rng(0)
    ys = tuple(jnp.asarray(_textured(h, w, seed=10 + i)) for i in range(batch))
    us = tuple(jnp.asarray(_textured(h // 2, w // 2, seed=50 + i))
               for i in range(batch))
    vs = tuple(jnp.asarray(_textured(h // 2, w // 2, seed=90 + i))
               for i in range(batch))
    rots = jnp.stack([
        so3.exp(jnp.asarray(x, jnp.float32))
        for x in rng.normal(size=(batch, 3)) * np.radians(correction_deg / 2)
    ])
    jax.block_until_ready((ys, us, vs, rots))
    jax.block_until_ready(warper.warp_yuv_batch(ys, us, vs, rots))  # compile

    per_frame_ms = []
    for _ in range(dispatches):
        t0 = time.perf_counter()
        jax.block_until_ready(warper.warp_yuv_batch(ys, us, vs, rots))
        per_frame_ms.append((time.perf_counter() - t0) * 1e3 / batch)
    per_frame_ms.sort()

    def pct(p):
        return round(per_frame_ms[min(len(per_frame_ms) - 1,
                                      int(p / 100 * len(per_frame_ms)))], 3)

    out = {
        "geometry": f"{w}x{h}",
        "correction_deg": correction_deg,
        "psnr_luma_db": round(psnr_y, 2),
        "psnr_chroma_u_db": round(psnr_u, 2),
        "psnr_chroma_v_db": round(psnr_v, 2),
        "psnr_gate_db": 45.0,
        "psnr_ok": bool(min(psnr_y, psnr_u, psnr_v) >= 45.0),
        "latency_batch": batch,
        "dispatches_timed": dispatches,
        "p50_warp_ms_per_frame": pct(50),
        "p99_warp_ms_per_frame": pct(99),
        "latency_target_ms": 4.0,
        "latency_ok": bool(pct(50) < 4.0),
        "backend": jax.default_backend(),
    }
    return out


def run_families(correction_deg: float) -> dict:
    """Per-family / per-interp fidelity rows vs each family's own oracle.

    BASELINE's 45 dB clause names the flagship bilinear rotation warp
    (measured by :func:`run`); these rows extend the committed evidence
    to every warp family a render can take (the reference's --filter
    set, ``src/render.ts:913-989``) and both 4-tap interp modes:

    - ``rotation_bicubic``: the 4-tap XLA warp vs cv2.remap
      INTER_CUBIC (Keys a=-0.75 — the same kernel) on float input,
      rounded to the same uint8 grid.
    - ``rotation_lanczos``: vs this framework's host-exact XLA
      ``lanczos_sample`` 4x4 formulation (cv2's INTER_LANCZOS4 is an
      8x8 window — a different resampler, not an oracle for v360's
      ``interp=lanczos``); the row checks the batched uint8 path against
      the float formulation.
    - ``similarity``: the XLA similarity warp vs cv2.warpAffine
      INTER_LINEAR WARP_INVERSE_MAP; interior crop (cv2 renormalizes
      border taps differently).
    - ``deshake``: the axis-wise translation warp vs cv2.warpAffine
      pure translation; interior crop excludes the blurred-edge fill
      (a deliberate divergence from BORDER_CONSTANT).

    Geometry: 4K for the rotation rows (the headline geometry); 1440p
    for the 2D families.
    """
    import cv2
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.models.deshake import warp_frame_deshake
    from video_annotator_tpu.models.similarity import warp_frame_similarity
    from video_annotator_tpu.ops.affine import similarity_matrix
    from video_annotator_tpu.ops.warp_xla import (
        compute_warp_map,
        lanczos_sample,
    )
    from video_annotator_tpu.pipeline.render import FrameWarper

    rows = {}

    # --- rotation family, 4-tap interps, 4K --------------------------------
    w, h = 3840, 2880
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    axis = np.asarray([0.45, 0.65, 0.61])
    rot = so3.exp(jnp.asarray(
        axis / np.linalg.norm(axis) * np.radians(correction_deg), jnp.float32))
    y = _textured(h, w, seed=1)

    u_dummy = jnp.asarray(_textured(h // 2, w // 2, seed=2))
    coords = None
    for interp, oracle_name in (("bicubic", "cv2.remap INTER_CUBIC"),
                                ("lanczos", "xla lanczos_sample 4x4")):
        warper = FrameWarper(in_cam, out_cam, interp=interp)
        if coords is None:
            # The warper even-crops its canvas; the oracle map must use
            # the warper's exact output size.
            coords = np.asarray(jax.jit(
                lambda r: compute_warp_map(
                    out_cam, in_cam, r, (warper.out_h, warper.out_w))
            )(rot))
        wy, _, _ = jax.block_until_ready(
            warper.warp_yuv(jnp.asarray(y), u_dummy, u_dummy, rot))
        ours = np.asarray(wy)
        if interp == "bicubic":
            ref = cv2.remap(
                y.astype(np.float32), coords[..., 0], coords[..., 1],
                cv2.INTER_CUBIC, borderMode=cv2.BORDER_CONSTANT,
            )
        else:
            ref = np.asarray(lanczos_sample(
                jnp.asarray(y.astype(np.float32)), jnp.asarray(coords)))
        ref = np.clip(np.round(ref), 0, 255).astype(np.uint8)
        rows[f"rotation_{interp}"] = {
            "geometry": f"{w}x{h}",
            "psnr_luma_db": round(psnr(ours, ref), 2),
            "oracle": oracle_name,
            # cv2 rows check against an implementation this repo does
            # not own; the lanczos row's oracle is the repo's own XLA
            # lanczos_sample (cv2 has no 4x4 lanczos), so it validates
            # the batched uint8 path against the in-repo
            # formulation only — weigh it accordingly.
            "oracle_independent": interp != "lanczos",
        }

    # --- 2D families, 1440p -------------------------------------------------
    w2, h2 = 1920, 1440
    y2 = _textured(h2, w2, seed=5)
    params = np.asarray([20.0, -15.0, 0.01, 0.01], np.float32)  # dx dy ang ls
    mat = np.asarray(similarity_matrix(jnp.asarray(params)))
    u2 = _textured(h2 // 2, w2 // 2, seed=6)
    sy, _, _ = jax.block_until_ready(warp_frame_similarity(
        jnp.asarray(y2, jnp.float32), jnp.asarray(u2, jnp.float32),
        jnp.asarray(u2, jnp.float32), jnp.asarray(params)))
    sy = np.clip(np.round(np.asarray(sy)), 0, 255).astype(np.uint8)
    ref = cv2.warpAffine(
        y2.astype(np.float32), mat[:2], (w2, h2),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT,
    )
    ref = np.clip(np.round(ref), 0, 255).astype(np.uint8)
    crop = np.s_[64:-64, 64:-64]
    rows["similarity"] = {
        "geometry": f"{w2}x{h2}",
        "psnr_luma_db": round(
            psnr(np.asarray(sy)[crop], ref[crop]), 2),
        "oracle": "cv2.warpAffine INTER_LINEAR WARP_INVERSE_MAP (interior)",
        "oracle_independent": True,
    }

    off = jnp.asarray([7.3, -4.6], jnp.float32)
    dy_, _, _ = jax.block_until_ready(warp_frame_deshake(
        jnp.asarray(y2), jnp.asarray(u2), jnp.asarray(u2), off,
        blur_edges=True))
    dy_ = np.clip(np.round(np.asarray(dy_)), 0, 255).astype(np.uint8)
    m = np.float32([[1, 0, 7.3], [0, 1, -4.6]])
    ref = cv2.warpAffine(
        y2.astype(np.float32), m, (w2, h2),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT,
    )
    ref = np.clip(np.round(ref), 0, 255).astype(np.uint8)
    rows["deshake"] = {
        "geometry": f"{w2}x{h2}",
        "psnr_luma_db": round(
            psnr(np.asarray(dy_)[crop], ref[crop]), 2),
        "oracle": "cv2.warpAffine translation (interior; edge blur "
                  "excluded by the crop)",
        "oracle_independent": True,
    }
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dispatches", type=int, default=24)
    ap.add_argument("--correction-deg", type=float, default=3.0)
    ap.add_argument("--no-families", dest="families", action="store_false",
                    help="skip the per-family PSNR rows (rotation "
                         "bicubic/lanczos, similarity, deshake)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    result = run(args.batch, args.dispatches, args.correction_deg)
    if args.families:
        result["families"] = run_families(args.correction_deg)
        result["families_psnr_ok"] = bool(all(
            r["psnr_luma_db"] >= 45.0 for r in result["families"].values()))
    from provenance import stamp

    stamp(result)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
