"""Side-by-side comparison grids (the ``--compare`` feature).

The reference renders N stabilizers into one tiled video by building N
parallel ffmpeg sub-graphs and compositing with ``overlay_opencl``
(``getComparisonPipeline``, ``src/render.ts:1052-1223``; grid solver at
``src/render.ts:1013-1050``). Natively this is simpler and cheaper: the
motion analysis runs ONCE, each mode derives its corrections from the same
trajectory, and tiles are assembled on device with array ops.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from video_annotator_tpu.io.video import VideoMeta, open_reader, open_writer
from video_annotator_tpu.pipeline.profiler import Progress, StageProfiler
from video_annotator_tpu.pipeline.render import (
    FrameWarper,
    RenderOptions,
    analyse,
    build_cameras,
    compute_corrections,
    output_fps,
)


def comparison_grid_size(n: int, cell_aspect: float = 4 / 3) -> tuple[int, int]:
    """(rows, cols) minimizing empty cells, then how far the total canvas
    aspect (``cols * cell_aspect / rows``) lands from a 16:9 display — the
    policy of the reference's grid solver (``src/render.ts:1013-1050``)."""
    best = None
    for cols in range(1, n + 1):
        rows = -(-n // cols)
        waste = rows * cols - n
        skew = abs((cols * cell_aspect) / max(rows, 1) - 16 / 9)
        key = (waste, skew)
        if best is None or key < best[0]:
            best = (key, (rows, cols))
    return best[1]


# Reference comp cells (dewobble_test.sh:47-62): dewobble-none,
# dewobble-sg, vidstab, deshake_opencl — same alias table `--filter` uses.
from video_annotator_tpu.models import FILTER_ALIASES as _FAMILY_ALIASES


def _parse_mode(m: str):
    """-> (family, stabilise, horizon_lock).

    'none'/'fixed'/'smooth' (rotation family, back-compat), a filter
    family 'vidstab'/'deshake'/'dewobble'[:stabilise], an optional
    '+lock' suffix (rotation family: horizon-locked cell), or 'horizon'
    (= 'none+lock', pure gravity roll leveling)."""
    base, plus, flag = m.partition("+")
    if plus and flag != "lock":
        raise ValueError(f"unknown compare mode suffix {m!r}")
    lock = bool(plus)
    if base == "horizon":
        return ("rotation", "none", True)
    fam, _, sub = base.partition(":")
    if fam in ("none", "fixed", "smooth"):
        return ("rotation", fam, lock)
    if fam not in _FAMILY_ALIASES:
        raise ValueError(f"unknown compare mode {m!r}")
    family = _FAMILY_ALIASES[fam]
    if lock and family != "rotation":
        raise ValueError(f"'+lock' needs the rotation family (got {m!r})")
    sub = sub or "smooth"
    if sub not in ("none", "fixed", "smooth"):
        # Without this, 2D families would silently smooth on a typo
        # ('vidstab:fixd') while rotation cells raise much later.
        raise ValueError(f"unknown stabilise mode {sub!r} in {m!r}")
    return (family, sub, lock)


def _label_stamps(labels: Sequence[str], cell_w: int, cell_h: int):
    """Pre-render each cell label once as (text_mask, outline_mask) uint8
    stamps sized to the cell — blitting two boolean masks per frame is
    ~free, unlike running the font rasterizer per frame per cell."""
    try:
        import cv2
    except Exception:  # pragma: no cover - cv2 is baked into this env
        return None
    fs = max(0.45, min(cell_w, cell_h * 4 / 3) / 820.0)
    th = max(1, int(round(fs * 2)))
    stamps = []
    for text in labels:
        (tw, tht), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                          fs, th)
        pad = 3 * th
        h = min(tht + base + 2 * pad, cell_h)
        w = min(tw + 2 * pad, cell_w)
        org = (pad, pad + tht)
        outline = np.zeros((h, w), np.uint8)
        cv2.putText(outline, text, org, cv2.FONT_HERSHEY_SIMPLEX, fs, 255,
                    th + 2, cv2.LINE_AA)
        glyph = np.zeros((h, w), np.uint8)
        cv2.putText(glyph, text, org, cv2.FONT_HERSHEY_SIMPLEX, fs, 255,
                    th, cv2.LINE_AA)
        stamps.append((glyph, outline))
    return stamps


def render_compare(
    source: str,
    dest: str,
    modes: Sequence[str],
    options: RenderOptions,
    profiler: StageProfiler | None = None,
) -> None:
    """Render each mode into one tiled output video.

    Modes are stabilise settings of the rotation family ('none', 'fixed',
    'smooth') and/or other filter families ('vidstab', 'deshake',
    optionally 'family:stabilise') — the reference's 4-way "comp" grid is
    ``--compare none,smooth,vidstab,deshake``. Analysis runs once PER
    FAMILY; all rotation-family cells share one trajectory."""
    prof = profiler or StageProfiler()
    if options.rolling_shutter:
        raise ValueError(
            "--rolling-shutter is not supported with --compare (cells "
            "warp with whole-frame poses); render modes separately"
        )
    parsed = [_parse_mode(m) for m in modes]
    fams = {f for f, _, _ in parsed}

    from video_annotator_tpu.pipeline.render import open_trimmed

    reader, meta, first, last = open_trimmed(source, options)

    def _count_frames():
        # Placeholder trajectories must cover the same TRIM WINDOW the
        # analysers honor (`last` is exclusive, render.py:_frame_range) —
        # sizing to the full clip would render from --start to EOF when
        # every cell is stabilise='none'. When the container has no
        # frame count (cv2 CAP_PROP_FRAME_COUNT 0), `last` is NOT
        # clamped to EOF even if --end/--duration bounded it, so a
        # bounded `last` can still overrun a short clip — count by
        # decoding once whenever the count is unknown.
        if last < (1 << 30) and meta.num_frames:
            return max(0, last - first)
        r = open_reader(source, prefer_native=options.native_io)
        n = sum(1 for _ in r)
        r.close()
        return max(0, min(last, n) - first)

    def _empty_traj(kind, dim):
        from video_annotator_tpu.pipeline.trajectory import Trajectory

        n = _count_frames()
        return Trajectory(np.zeros((n, dim)), kind, meta.fps, meta.width,
                          meta.height, source)

    trajs = {}
    any_lock = any(lk for _, _, lk in parsed)
    if "rotation" in fams:
        rot_cells = [(s, lk) for f, s, lk in parsed if f == "rotation"]
        trajs["rotation"] = (
            # Locked cells need the measured attitude (and the telemetry
            # up-vector when present) even at stabilise=none.
            analyse(
                source,
                dataclasses.replace(
                    options, horizon_lock=options.horizon_lock or any_lock
                ),
                prof,
            )
            if any(s != "none" or lk for s, lk in rot_cells)
            else _empty_traj("so3", 3)
        )
    if "similarity" in fams:
        from video_annotator_tpu.models.similarity import analyse_similarity

        trajs["similarity"] = analyse_similarity(source, options, prof)
    if "deshake" in fams:
        from video_annotator_tpu.models.deshake import analyse_deshake

        trajs["deshake"] = analyse_deshake(source, options, prof)

    # The shared grid canvas must include the stabilise-buffer zoom when
    # ANY rotation cell stabilises (or levels) — the standalone render
    # gets it from its own options.stabilise.
    any_rot_stab = any(
        f == "rotation" and (s != "none" or lk) for f, s, lk in parsed
    )
    in_cam, out_cam = build_cameras(
        meta,
        dataclasses.replace(options, stabilise="smooth")
        if any_rot_stab and options.stabilise == "none"
        else options,
    )
    per_mode = []
    for fam, sub, lock in parsed:
        o = dataclasses.replace(
            options, stabilise=sub,
            horizon_lock=(options.horizon_lock or lock) if fam == "rotation"
            else False,
        )
        if fam == "rotation":
            per_mode.append(("rotation", compute_corrections(trajs[fam], o)))
        elif fam == "similarity":
            from video_annotator_tpu.models.similarity import (
                similarity_corrections,
            )

            per_mode.append((fam, similarity_corrections(trajs[fam], o)))
        else:
            from video_annotator_tpu.models.deshake import deshake_corrections

            per_mode.append((fam, deshake_corrections(trajs[fam], o)))
    num_frames = min(t.num_frames for t in trajs.values()) if trajs else 0

    warper = FrameWarper(in_cam, out_cam,
                         prefilter=options.prefilter == "auto",
                         interp=options.interp)

    rows, cols = comparison_grid_size(len(modes))
    cell_h = warper.out_h - warper.out_h % 2
    cell_w = warper.out_w - warper.out_w % 2
    stamps = (_label_stamps(list(modes), cell_w, cell_h)
              if getattr(options, "cell_labels", True) else None)

    def label_cells(luma: np.ndarray) -> np.ndarray:
        """Alpha-blend each mode's name (white, black outline) into the
        top-left of its cell — luma only, so the text is colorless."""
        if not stamps:
            return luma
        for i, (glyph, outline) in enumerate(stamps):
            r, c = divmod(i, cols)
            sh, sw = glyph.shape
            region = luma[r * cell_h : r * cell_h + sh,
                          c * cell_w : c * cell_w + sw]
            o16 = outline.astype(np.uint16)
            g16 = glyph.astype(np.uint16)
            blended = region.astype(np.uint16) * (255 - o16) // 255
            blended = (blended * (255 - g16) + 255 * g16) // 255
            region[:] = blended.astype(np.uint8)
        return luma
    out_meta = VideoMeta(
        cell_w * cols, cell_h * rows,
        # --frame-rate retimes the output like every other render path.
        output_fps(options, meta),
        num_frames,
    )
    from video_annotator_tpu.pipeline.render import CropSink, apply_crop_rect

    write_meta, crop_r = apply_crop_rect(out_meta, options)
    writer = open_writer(None if options.no_output else dest, write_meta,
                         encoder=options.encoder)
    if crop_r:
        writer = CropSink(writer, crop_r)

    def fit(p, h, w, fill):
        """Center-crop/pad a plane to the cell size (other families
        warp at the INPUT size; the reference instead rescales each
        sub-graph's dfov — functionally the same comparison surface).
        Padding is black for luma (0) and NEUTRAL for chroma (128) —
        zero chroma would band the cells in saturated green."""
        p = np.asarray(p)
        ph, pw = p.shape
        top = max((ph - h) // 2, 0)
        left = max((pw - w) // 2, 0)
        p = p[top:top + h, left:left + w]
        ph, pw = p.shape
        if ph != h or pw != w:
            oy, ox = (h - ph) // 2, (w - pw) // 2
            canvas = np.full((h, w), fill, p.dtype)
            canvas[oy:oy + ph, ox:ox + pw] = p
            p = canvas
        return p

    def tile(planes_list, scale):
        h, w = cell_h // scale, cell_w // scale
        fill = 0 if scale == 1 else 128  # luma vs chroma neutral
        canvas = np.full((h * rows, w * cols), fill, np.uint8)
        for i, p in enumerate(planes_list):
            r, c = divmod(i, cols)
            canvas[r * h : (r + 1) * h, c * w : (c + 1) * w] = fit(
                np.clip(np.round(np.asarray(p)), 0, 255).astype(np.uint8),
                h, w, fill,
            )
        return canvas

    # Honor the trim window like the analysers do (corrections index from
    # the trimmed range's first frame); the reader was opened seeked to it.
    t = 0
    idx = reader.start_frame - 1
    prog = Progress("compare", total=num_frames)
    try:
        for y, u, v in prof.wrap_iter("decode", iter(reader)):
            idx += 1
            if idx < first:
                continue
            if t >= num_frames:
                break
            ys, us, vs = [], [], []
            with prof.stage("warp"):
                yj = jnp.asarray(y, jnp.float32)
                uj = jnp.asarray(u, jnp.float32)
                vj = jnp.asarray(v, jnp.float32)
                for fam, corr in per_mode:
                    if fam == "rotation":
                        rot = jnp.asarray(corr[t], jnp.float32)
                        wy, wu, wv = warper.warp_yuv(yj, uj, vj, rot)
                    elif fam == "similarity":
                        from video_annotator_tpu.models.similarity import (
                            warp_frame_similarity,
                        )

                        wy, wu, wv = warp_frame_similarity(
                            yj, uj, vj, jnp.asarray(corr[t], jnp.float32),
                            interp=options.interp,
                        )
                    else:
                        from video_annotator_tpu.models.deshake import (
                            warp_frame_deshake,
                        )

                        wy, wu, wv = warp_frame_deshake(
                            yj, uj, vj, jnp.asarray(corr[t], jnp.float32)
                        )
                    ys.append(wy)
                    us.append(wu)
                    vs.append(wv)
            with prof.stage("encode"):
                writer.write((label_cells(tile(ys, 1)),
                              tile(us, 2), tile(vs, 2)))
            t += 1
            prog.tick()
    except BaseException:
        try:
            writer.close()
        except Exception:
            pass
        reader.close()
        raise
    prog.close()
    writer.close()
    reader.close()
    if options.verbose:
        print(prof.report())
