"""On-device smoke test: the stabilizer's main path on one GPU at 4K.

    python chip_smoke.py

Runs, on the first accelerator JAX finds, at GoPro 4K width (3840x2880):

1. device check — exits non-zero, printing no result, without a GPU;
2. the encode's batched YUV warps (``FrameWarper.warp_yuv_batch``:
   bilinear, bicubic, lanczos, a rolling-shutter stack; and
   ``warp_2d_batch_fn`` for similarity and deshake), each against the
   float64 NumPy reference (``ops/warp_ref.py``) and against the same
   jitted function on the CPU; times are the warp kernel's alone;
3. paired and tracked analyse of a shaky synthetic clip against its
   ground-truth trajectory;
4. ``render --stabilise smooth`` through the CLI entry point: two-phase
   and ``--streaming``, then ``--filter vidstab`` and ``--filter deshake``,
   each checked against the warp of the same input frames;
5. timings (ms/frame), each printed beside the card's name and power limit.

Every phase raises on failure. The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Precision: on this card XLA may run float32 matrix products and
convolutions in TF32 (about three decimal digits) unless a precision is
asked for. The warp has none (map math is elementwise; its one rotation
einsum asks for HIGHEST), and the deshake blur and the trajectory
smoother ask for HIGHEST, so the tolerances below are set by float32
rounding, not by TF32:

- vs the float64 reference: PSNR >= 45 dB per plane (the BASELINE.json
  fidelity gate). The device map is float32, so coordinates differ from
  float64 by ~1e-4 px and a few pixels round the other way.
- vs the same function on the CPU: max |diff| <= 1 level and >= 99.9 % of
  pixels identical. Both backends compute float32 maps, but may contract
  multiply-adds and order sums differently; a last-bit coordinate
  difference flips the rounding of a pixel near a half level. The test
  frames are band-limited random fields (random values on a 1/32-res
  grid, upsampled; ~3 levels/px), so a last-bit coordinate shift flips
  a few hundredths of a percent of pixels (a 1/8-res grid measured
  99.90 % identical on the H100, at the limit); white noise would turn
  the same last-bit differences into percent-level flips that are no
  error of the warp.
- deshake's blurred-edge fill vs the reference's independent float64
  blur: within 1 level and >= 99.9 % identical over the fill region.
  float32 sums move a fill pixel by ~1e-4 level; TF32 would move it by
  ~0.1 level and flip a tenth or more of them.
- analyse vs the synthetic ground truth: see ``RMS_BOUND_DEG``.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

W, H = 3840, 2880  # GoPro 4K, 4:3
BATCH = 8
CLIP = 48
SCALE = 0.5  # --analysis-scale auto at 4K
# Trajectory RMS bounds vs ground truth on this clip at analysis scale 0.5
# (degrees): three times what the CPU backend reads on the same clip
# (paired 0.00101, tracked 0.00085), so a tracker several times worse on
# the card (TF32 in the LK gradients or the pyramid) fails.
RMS_BOUND_DEG = {"paired": 0.003, "tracked": 0.0025}
# Device memory bandwidth by device_kind (NVIDIA data sheets), bytes/s.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # SXM
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def smooth_random_planes(n, h, w, seed):
    """n band-limited random uint8 YUV 4:2:0 frames (see module doc)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def field(hh, ww):
        lo = rng.uniform(0, 255, (hh // 32 + 2, ww // 32 + 2))
        yy = np.arange(hh) / 32.0
        xx = np.arange(ww) / 32.0
        y0 = yy.astype(int)
        x0 = xx.astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        top = lo[y0][:, x0] * (1 - fx) + lo[y0][:, x0 + 1] * fx
        bot = lo[y0 + 1][:, x0] * (1 - fx) + lo[y0 + 1][:, x0 + 1] * fx
        return np.round(top * (1 - fy) + bot * fy).astype(np.uint8)

    frames = [(field(h, w), field(h // 2, w // 2), field(h // 2, w // 2))
              for _ in range(n)]
    return tuple(zip(*frames))


def psnr(a, b):
    import numpy as np

    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def check_oracle(tag, got, want, gate_db=45.0):
    db = psnr(got, want)
    assert db >= gate_db, f"{tag}: PSNR {db:.2f} dB vs reference < {gate_db}"
    return db


def check_close(tag, got, want, max_diff=1, min_identical=0.999):
    """uint8 pixels within ``max_diff`` levels, identical almost everywhere."""
    import numpy as np

    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    same = float((d == 0).mean())
    assert d.max() <= max_diff and same >= min_identical, (
        f"{tag}: max|diff| {d.max()}, identical {same:.5f}")
    return same


def timed(fn, reps=5):
    """Median wall seconds of ``fn()`` (each call ends in a device sync)."""
    import jax

    jax.block_until_ready(fn())  # compile / warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def on_cpu(fn, *args):
    """Run ``fn`` with host (NumPy) arguments on the CPU backend."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return jax.device_get(fn(*args))


def phase_warp(w, h, n, timings):
    """Rotation family at full width vs the reference and the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu.ops.warp_ref import warp_yuv420_np
    from video_annotator_tpu.pipeline.render import FrameWarper

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    ys, us, vs = smooth_random_planes(n, h, w, seed=1)
    rng = np.random.default_rng(2)
    rvs = rng.normal(size=(n, 3)) * 0.01
    rots = np.asarray(so3.exp(jnp.asarray(rvs, jnp.float32)))
    warper = FrameWarper(in_cam, out_cam)
    # Rolling shutter: per-band poses sweeping across the frame.
    n_bands = -(-warper.out_h // 8)
    sweep = 0.5 + np.arange(n_bands) / n_bands
    rs = np.asarray(so3.exp(jnp.asarray(
        rvs[:, None, :] * sweep[None, :, None], jnp.float32)))
    dev = [tuple(jax.device_put(p) for p in planes) for planes in (ys, us, vs)]
    size = (warper.out_h, warper.out_w)
    for interp, stack in (("bilinear", rots), ("bicubic", rots),
                          ("lanczos", rots), ("rolling-shutter", rs)):
        warper = FrameWarper(in_cam, out_cam,
                             interp="bilinear" if stack is rs else interp)
        rot_dev = jax.device_put(stack)
        outs = jax.device_get(warper.warp_yuv_batch(*dev, rot_dev))
        cpu = on_cpu(warper.warp_yuv_batch, ys, us, vs, stack)
        same = min(check_close(f"warp {interp} frame {i} plane {p}", g, c)
                   for i in range(n)
                   for p, (g, c) in enumerate(zip(outs[i], cpu[i])))
        ref = warp_yuv420_np(ys[0], us[0], vs[0], out_cam, in_cam, stack[0],
                             size, interp=warper.interp)
        dbs = [check_oracle(f"warp {interp} plane {p}", g, r)
               for p, (g, r) in enumerate(zip(outs[0], ref))]
        dt = timed(lambda: warper.warp_yuv_batch(*dev, rot_dev))
        timings[f"warp_{interp}_ms_per_frame"] = dt / n * 1e3
        log(f"warp {interp} {w}x{h} -> {size[1]}x{size[0]} batch {n}: "
            f"PSNR vs reference (Y,U,V) "
            f"{', '.join(f'{d:.2f}' for d in dbs)} dB; identical to CPU "
            f"{same * 100:.3f} %; {dt / n * 1e3:.3f} ms/frame")
    bytes_moved = n * (h * w * 3 // 2 + size[0] * size[1] * 3 // 2)
    timings["warp_bytes_per_frame"] = bytes_moved / n


def phase_2d_families(w, h, n, timings):
    """Similarity (vidstab) and deshake: the encode's batched warp
    (``warp_2d_batch_fn``) at full width, kernel time only (no decode or
    write; phase 4 renders both through the CLI)."""
    import jax
    import numpy as np

    from video_annotator_tpu.ops.warp_ref import (
        deshake_yuv420_np,
        similarity_yuv420_np,
    )
    from video_annotator_tpu.pipeline.render import warp_2d_batch_fn

    ys, us, vs = smooth_random_planes(n, h, w, seed=3)
    rng = np.random.default_rng(4)
    sim_p = (rng.normal(size=(n, 4)) * [6.0, 6.0, 0.005, 0.005]).astype(np.float32)
    # Whole eighths: float32 tap weights are exact, so the reference's
    # half-level ties round alike and only the blur can flip a pixel.
    des_p = (np.round(rng.normal(size=(n, 2)) * 48.0) / 8.0).astype(np.float32)
    dev = [tuple(jax.device_put(p) for p in planes) for planes in (ys, us, vs)]

    for tag, kind, params in (("similarity", "similarity", sim_p),
                              ("deshake", "translation", des_p)):
        fn = warp_2d_batch_fn(kind, (h, w), (h, w), "bilinear")
        got = jax.device_get(fn(*dev, jax.device_put(params)))
        cpu = on_cpu(fn, ys, us, vs, params)
        same = min(check_close(f"{tag} frame {i} plane {p}", g, c)
                   for i in range(n)
                   for p, (g, c) in enumerate(zip(got[i], cpu[i])))
        if kind == "similarity":
            ref = similarity_yuv420_np(ys[0], us[0], vs[0], params[0])
        else:
            ref = deshake_yuv420_np(ys[0], us[0], vs[0], params[0])
        dbs = [check_oracle(f"{tag} plane {p}", g, r)
               for p, (g, r) in enumerate(zip(got[0], ref))]
        msg = (f"{tag} {w}x{h} batch {n}: identical to CPU {same * 100:.3f} %"
               "; PSNR vs reference (Y,U,V) "
               + ", ".join(f"{x:.2f}" for x in dbs) + " dB")
        if kind == "translation":
            # The blurred-edge fill comes from two banded float32 matmuls
            # (HIGHEST); TF32 there would move its pixels by ~0.1 level
            # and flip a tenth of them.
            xs = np.arange(w) + params[0][0]
            yy = np.arange(h) + params[0][1]
            fill = ~(((xs >= 0) & (xs <= w - 1))[None, :]
                     & ((yy >= 0) & (yy <= h - 1))[:, None])
            assert fill.sum() > 1000, "deshake offsets reveal no border"
            fsame = check_close("deshake blurred-edge fill vs reference",
                              got[0][0][fill], ref[0][fill])
            msg += (f"; fill region ({int(fill.sum())} px) identical to "
                    f"reference {fsame * 100:.3f} %")
        dt = timed(lambda: fn(*dev, jax.device_put(params)))
        timings[f"{tag}_kernel_ms_per_frame"] = dt / n * 1e3
        log(f"{msg}; {dt / n * 1e3:.3f} ms/frame (warp kernel only)")


def trajectory_rms_deg(traj, src):
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import so3
    from video_annotator_tpu.io.synthetic import SyntheticSource

    r_true = np.asarray(so3.exp(jnp.asarray(
        SyntheticSource.from_uri(src).config.rotation_vectors())), np.float64)
    r_expect = r_true.transpose(0, 2, 1) @ r_true[0]
    r_est = np.asarray(traj.rotations(), np.float64)
    assert len(r_est) == len(r_expect), (len(r_est), len(r_expect))
    errs = [np.linalg.norm(np.asarray(so3.log(jnp.asarray(
        (r_est[t] @ r_expect[t].T).astype(np.float32))))) for t in range(len(r_est))]
    return float(np.degrees(np.sqrt(np.mean(np.square(errs)))))


def phase_analyse(src, n, timings):
    """Paired and tracked analyse: ``analyse()`` on the synthetic clip
    (checked against ground truth; its wall time includes tracing and
    compilation), then the steady-state device time of the same jitted
    analyse chunks over device-resident frames."""
    import jax
    import jax.numpy as jnp

    from video_annotator_tpu.camera import CameraPreset
    from video_annotator_tpu.io.synthetic import SyntheticSource
    from video_annotator_tpu.pipeline.render import (
        RenderOptions,
        _make_pair_tracker,
        _make_tracker,
        analyse,
    )

    source = SyntheticSource.from_uri(src)
    frames = [source._render(jnp.asarray(r))[0]
              for r in source.config.rotations()]
    meta, chunk = source.meta, 16
    starts = range(1, n - chunk + 1, chunk)  # full chunks only
    for mode in ("paired", "tracked"):
        opts = RenderOptions(stabilise="smooth", analysis_mode=mode,
                             analysis_scale=SCALE, analysis_chunk=chunk,
                             preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
        t0 = time.perf_counter()
        traj = analyse(src, opts)
        cold = time.perf_counter() - t0
        rms = trajectory_rms_deg(traj, src)
        assert rms <= RMS_BOUND_DEG[mode], (
            f"{mode} analyse: trajectory RMS {rms:.5f} deg > "
            f"{RMS_BOUND_DEG[mode]}")

        if mode == "paired":
            pair_chunk = _make_pair_tracker(meta, opts)
            stacks = [jnp.stack(frames[i - 1:i + chunk]) for i in starts]

            def run():
                r = d = jnp.eye(3, dtype=jnp.float32)
                key = jax.random.PRNGKey(7)
                outs = []
                for j, s in enumerate(stacks):
                    r, d, rs = pair_chunk(r, d, key, jnp.int32(j * chunk), s)
                    outs.append(rs)
                return outs
        else:
            detect_step, _, track_chunk = _make_tracker(meta, opts)
            stacks = [jnp.stack(frames[i:i + chunk]) for i in starts]

            def run():
                pts, valid, prev = detect_step(frames[0])
                eye = jnp.eye(3, dtype=jnp.float32)
                carry = (pts, valid, prev, eye, eye, jax.random.PRNGKey(7),
                         jnp.int32(0))
                outs = []
                for s in stacks:
                    carry, ras = track_chunk(*carry, s)
                    outs.append(ras)
                return outs

        steady = timed(run, reps=3) / (len(stacks) * chunk)
        timings[f"analyse_{mode}_ms_per_frame"] = steady * 1e3
        timings[f"analyse_{mode}_cold_s"] = cold
        log(f"analyse {mode} scale {SCALE}: {n} frames, trajectory RMS vs "
            f"ground truth {rms:.5f} deg (bound {RMS_BOUND_DEG[mode]}); "
            f"steady {steady * 1e3:.3f} ms/frame device-resident; "
            f"analyse() {cold:.1f} s cold (synthetic source, tracing and "
            "compilation included)")


def phase_render(src, n, timings, tmp):
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import cli
    from video_annotator_tpu.io.synthetic import SyntheticSource
    from video_annotator_tpu.io.video import open_reader
    from video_annotator_tpu.pipeline.render import (
        FrameWarper,
        build_cameras,
        compute_corrections,
    )
    from video_annotator_tpu.pipeline.trajectory import Trajectory, trajectory_path

    source = SyntheticSource.from_uri(src)
    frames = [f for t, f in enumerate(source) if t in (0, n - 1)]
    for tag, extra in (("two-phase", []), ("streaming", ["--streaming"])):
        dst = os.path.join(tmp, f"{tag}.y4m")
        argv = ["render", src, dst, "--stabilise", "smooth"] + extra
        t0 = time.perf_counter()
        rc = cli.main(argv)
        dt = time.perf_counter() - t0
        assert rc == 0, f"render {tag} exited {rc}"
        opts = cli._render_options(cli.build_parser().parse_args(argv))
        in_cam, out_cam = build_cameras(source.meta, opts)
        warper = FrameWarper(in_cam, out_cam)
        out = list(open_reader(dst))
        assert len(out) == n, f"{tag}: {len(out)} frames, want {n}"
        assert out[0][0].shape == (warper.out_h, warper.out_w), out[0][0].shape
        corr = compute_corrections(Trajectory.load(trajectory_path(dst)), opts)
        angles = np.degrees(np.arccos(np.clip(
            (np.einsum("tii->t", corr.astype(np.float64)) - 1) / 2, -1, 1)))
        assert angles.max() > 0.05, f"{tag}: corrections are identity"
        want = warper.warp_yuv_batch(
            *zip(frames[0], frames[-1]), jnp.asarray(corr[[0, -1]]))
        for i, t in enumerate((0, n - 1)):
            for p in range(3):
                check_close(f"render {tag} frame {t} plane {p} vs FrameWarper",
                          out[t][p], np.asarray(want[i][p]))
        os.remove(dst)
        timings[f"render_{tag}_cold_ms_per_frame"] = dt / n * 1e3
        log(f"render {tag} (CLI): {n} frames {out[0][0].shape[1]}x"
            f"{out[0][0].shape[0]}, max correction {angles.max():.3f} deg, "
            f"first/last frames match FrameWarper; {dt:.1f} s cold")
    for flt in ("vidstab", "deshake"):
        phase_render_2d(src, n, flt, frames, timings, tmp)
    argv = ["render", src, os.path.join(tmp, "warm.y4m"), "--stabilise",
            "smooth", "--no-output"]
    t0 = time.perf_counter()
    assert cli.main(argv) == 0
    dt = time.perf_counter() - t0
    timings["render_two_phase_warm_ms_per_frame"] = dt / n * 1e3
    log(f"render two-phase warm --no-output: {dt / n * 1e3:.3f} ms/frame")


def phase_render_2d(src, n, flt, frames, timings, tmp):
    """``render --filter vidstab|deshake --stabilise smooth`` through the
    CLI, checked against the batched 2D warp of the same input frames
    with the corrections the render's trajectory gives."""
    import jax.numpy as jnp
    import numpy as np

    from video_annotator_tpu import cli
    from video_annotator_tpu.io.video import open_reader
    from video_annotator_tpu.models.deshake import deshake_corrections
    from video_annotator_tpu.models.similarity import similarity_corrections
    from video_annotator_tpu.pipeline.render import warp_2d_batch_fn
    from video_annotator_tpu.pipeline.trajectory import Trajectory, trajectory_path

    dst = os.path.join(tmp, f"{flt}.y4m")
    argv = ["render", src, dst, "--stabilise", "smooth", "--filter", flt]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    assert rc == 0, f"render {flt} exited {rc}"
    opts = cli._render_options(cli.build_parser().parse_args(argv))
    traj = Trajectory.load(trajectory_path(dst))
    corr = {"similarity": similarity_corrections,
            "translation": deshake_corrections}[traj.kind](traj, opts)
    out = list(open_reader(dst))
    h, w = frames[0][0].shape
    assert len(out) == n, f"{flt}: {len(out)} frames, want {n}"
    assert out[0][0].shape == (h, w), out[0][0].shape
    # A fixed zoom (the similarity family's stabilise buffer) is constant;
    # a stabilizing correction varies from frame to frame.
    spread = float(np.ptp(corr[:, :2], axis=0).max())
    assert spread > 0.5, f"{flt}: corrections do not move ({spread:.3f} px)"
    warp = warp_2d_batch_fn(traj.kind, (h, w), (h, w), opts.interp)
    want = warp(*zip(frames[0], frames[-1]), jnp.asarray(corr[[0, -1]]))
    for i, t in enumerate((0, n - 1)):
        for p in range(3):
            check_close(f"render {flt} frame {t} plane {p} vs batched warp",
                        out[t][p], np.asarray(want[i][p]))
    os.remove(dst)
    timings[f"render_{flt}_cold_ms_per_frame"] = dt / n * 1e3
    log(f"render --filter {flt} (CLI): {n} frames {w}x{h}, correction "
        f"spread {spread:.2f} px, first/last frames match the batched "
        f"warp; {dt:.1f} s cold")


def phase_copy(timings):
    """What a plain large device copy reaches (the warp's bandwidth yardstick)."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1 << 30,), jnp.uint8)
    copy = jax.jit(lambda a: a + jnp.uint8(1))
    dt = timed(lambda: copy(x))
    timings["copy_GBps"] = 2 * x.size / dt / 1e9
    log(f"device copy 1 GiB: {timings['copy_GBps']:.1f} GB/s (read + write)")


def main():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    kind = devices[0].device_kind
    log(f"jax {jax.__version__}, device {kind} x{len(devices)}")

    timings = {}
    t_start = time.perf_counter()
    phase_warp(W, H, BATCH, timings)
    phase_2d_families(W, H, BATCH, timings)
    src = f"synthetic://shaky?w={W}&h={H}&n={CLIP}&seed=11&shake=0.008"
    phase_analyse(src, CLIP, timings)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_render(src, CLIP, timings, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_copy(timings)

    peak = HBM_BYTES_PER_S.get(kind)
    floor_us = (timings["warp_bytes_per_frame"] / peak * 1e6
                if peak else None)
    for k in sorted(timings):
        log(f"[{card}] {k}: {timings[k]!r}")
    if peak:
        share = floor_us / (timings["warp_bilinear_ms_per_frame"] * 1e3)
        log(f"[{card}] warp bilinear HBM floor {floor_us:.1f} us/frame "
            f"at {peak / 1e12:.2f} TB/s; achieved share {share * 100:.1f} %")
    else:
        log(f"[{card}] no HBM peak on record for {kind}: share not computed")
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
