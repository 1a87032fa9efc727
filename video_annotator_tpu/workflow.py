"""Match-processing workflow: the native analogue of ``concat.sh``.

The reference's L6 layer is a bash workflow over a recorded match
(``concat.sh:341-360``): ``stabilise`` (parallel per-segment motion
analysis, ``concat.sh:197-219``), ``join`` (``:192-195``), ``tag``
(interactive timecode/score capture into sourceable metadata files,
``:136-190``), ``split`` (per-set renders claimed via lockfiles so
concurrent workers never collide and crashed jobs resume,
``:221-283``), and ``encode`` (final re-encode, ``:285-335``).

This module reimplements that workflow natively: metadata lives in a JSON
file next to the footage, work-claiming uses the same lockfile +
``.complete``-marker idempotence, and the heavy lifting calls straight into
the pipeline instead of shelling out to ffmpeg.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from video_annotator_tpu.io.gopro import find_source_segments


@dataclasses.dataclass
class MatchSet:
    """One set of a match: trim range plus score annotations."""

    start: float  # seconds into the joined video
    end: float
    score: str = ""  # e.g. "21-19"


@dataclasses.dataclass
class MatchMeta:
    code: str
    sets: List[MatchSet]

    @staticmethod
    def path(code: str, directory: str = ".") -> str:
        return os.path.join(directory, f"match_{code}.json")

    def save(self, directory: str = "."):
        with open(self.path(self.code, directory), "w") as f:
            json.dump(
                {
                    "code": self.code,
                    "sets": [dataclasses.asdict(s) for s in self.sets],
                },
                f,
                indent=2,
            )

    @staticmethod
    def load(code: str, directory: str = ".") -> "MatchMeta":
        with open(MatchMeta.path(code, directory)) as f:
            d = json.load(f)
        return MatchMeta(
            code=d["code"], sets=[MatchSet(**s) for s in d["sets"]]
        )


def tag(code: str, directory: str = ".", sets_json: Optional[str] = None):
    """Capture set timecodes/scores (``concat.sh:136-190``).

    Interactive prompts by default; ``sets_json`` takes a JSON array of
    ``{"start": s, "end": s, "score": "21-19"}`` for scripted use.
    """
    if sets_json:
        sets = [MatchSet(**s) for s in json.loads(sets_json)]
    else:
        sets = []
        print("Enter sets (empty start to finish):")
        while True:
            start = input(f"set {len(sets) + 1} start (seconds): ").strip()
            if not start:
                break
            end = input("  end (seconds): ").strip()
            score = input("  score: ").strip()
            sets.append(MatchSet(float(start), float(end), score))
    MatchMeta(code, sets).save(directory)
    print(f"wrote {MatchMeta.path(code, directory)} ({len(sets)} sets)")


def _claim(lockfile: str) -> bool:
    """Lockfile-based work claiming (``concat.sh:260-273``): first worker
    to O_EXCL-create the lock owns the job; stale completes are skipped."""
    try:
        fd = os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    return True


def stabilise(code: str, directory: str = ".", concurrency: int = 2):
    """Per-segment motion analysis in parallel (``concat.sh:197-219``:
    vidstabdetect across segments with xargs -P). Trajectories are the
    ``.trf`` analogues, claimed via lockfiles so re-runs resume."""
    from video_annotator_tpu.pipeline.render import RenderOptions, analyse
    from video_annotator_tpu.pipeline.trajectory import trajectory_path

    segments = find_source_segments(code, directory)

    def work(seg: str):
        tpath = trajectory_path(seg)
        done = tpath + ".complete"
        lock = tpath + ".lock"
        if os.path.exists(done):
            return f"{seg}: already analysed"
        if not _claim(lock):
            return f"{seg}: claimed by another worker"
        try:
            traj = analyse(seg, RenderOptions())
            traj.save(tpath)
            open(done, "w").close()
            return f"{seg}: {traj.num_frames} frames analysed"
        finally:
            os.unlink(lock)

    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        for msg in ex.map(work, segments):
            print(msg)


def gpu_host() -> bool:
    """Whether a render process started from here would open a GPU,
    decided without starting JAX in this process (a JAX process reserves
    most of the card's memory the moment it first uses it)."""
    held_to_cpu = os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"
    return not held_to_cpu and shutil.which("nvidia-smi") is not None


def split(
    code: str,
    directory: str = ".",
    concurrency: int = 1,
    render_args: Optional[List[str]] = None,
):
    """Render each tagged set to its own file (``concat.sh:221-283``).

    Work units are claimed with lockfiles and marked with ``.complete``
    files, so crashed or concurrent runs are safe to re-invoke. Renders run
    as separate CLI processes (the reference's process-level parallelism).
    Each render process reserves most of the card's memory at start-up,
    so on a GPU host ``concurrency`` must stay 1.
    """
    if concurrency > 1 and gpu_host():
        raise ValueError(
            f"split --concurrency {concurrency}: every render process "
            "reserves most of the GPU's memory at start-up, so concurrent "
            "renders on this host fail for want of memory; use "
            "--concurrency 1"
        )
    meta = MatchMeta.load(code, directory)
    joined = os.path.join(directory, f"match_{code}.mp4")
    if not os.path.exists(joined):
        alt = os.path.join(directory, f"match_{code}.y4m")
        if os.path.exists(alt):
            joined = alt
        else:
            raise FileNotFoundError(
                f"joined video not found: {joined} (run 'join {code}' first)"
            )
    ext = os.path.splitext(joined)[1]

    def work(i_set):
        i, s = i_set
        out = os.path.join(directory, f"match_{code}_set{i + 1}{ext}")
        done = out + ".complete"
        lock = out + ".lock"
        if os.path.exists(done):
            return f"set {i + 1}: already rendered"
        if not _claim(lock):
            return f"set {i + 1}: claimed by another worker"
        try:
            cmd = [
                sys.executable, "-m", "video_annotator_tpu", "render",
                joined, out, "-s", str(s.start), "-e", str(s.end),
            ] + (render_args or [])
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                return f"set {i + 1}: FAILED\n{r.stderr[-500:]}"
            open(done, "w").close()
            return f"set {i + 1}: rendered to {out}"
        finally:
            os.unlink(lock)

    with ThreadPoolExecutor(max_workers=max(concurrency, 1)) as ex:
        for msg in ex.map(work, enumerate(meta.sets)):
            print(msg)


def encode(code: str, directory: str = ".", encoder: Optional[str] = None):
    """Re-encode the per-set renders to their final form
    (``concat.sh:285-335``'s NVENC/VAAPI stage; native libx264 at QP 19
    when built, cv2 otherwise)."""
    from video_annotator_tpu.io.video import (
        default_encoder,
        open_reader,
        open_writer,
    )

    encoder = encoder or default_encoder()

    meta = MatchMeta.load(code, directory)
    for i in range(len(meta.sets)):
        src = None
        for ext in (".y4m", ".mp4"):
            cand = os.path.join(directory, f"match_{code}_set{i + 1}{ext}")
            if os.path.exists(cand):
                src = cand
                break
        if src is None:
            print(f"set {i + 1}: no render found, skipping")
            continue
        out = os.path.join(directory, f"match_{code}_set{i + 1}_final.mp4")
        done = out + ".complete"
        if os.path.exists(done):
            print(f"set {i + 1}: already encoded")
            continue
        reader = open_reader(src)
        writer = open_writer(out, reader.meta, encoder=encoder,
                             copy_streams_from=src)
        n = 0
        for planes in reader:
            writer.write(planes)
            n += 1
        writer.close()
        reader.close()
        open(done, "w").close()
        print(f"set {i + 1}: encoded {n} frames to {out}")
