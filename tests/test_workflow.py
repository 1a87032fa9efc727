"""Match-workflow tests: metadata, lockfile idempotence, split renders."""

import json
import os

import numpy as np
import pytest
from fractions import Fraction

from video_annotator_tpu.io.video import VideoMeta, open_reader, open_writer
from video_annotator_tpu.workflow import (
    MatchMeta,
    MatchSet,
    _claim,
    split,
    stabilise,
    tag,
)


def _write_clip(path, n=20, w=96, h=64):
    wr = open_writer(path, VideoMeta(w, h, Fraction(10, 1)))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (h, w), np.uint8)
    for i in range(n):
        wr.write(
            (
                np.roll(base, i, axis=1),
                np.full((h // 2, w // 2), 128, np.uint8),
                np.full((h // 2, w // 2), 128, np.uint8),
            )
        )
    wr.close()


def test_match_meta_roundtrip(tmp_path):
    d = str(tmp_path)
    meta = MatchMeta("1234", [MatchSet(0.0, 1.0, "21-15"), MatchSet(1.0, 2.0)])
    meta.save(d)
    back = MatchMeta.load("1234", d)
    assert back.sets[0].score == "21-15"
    assert back.sets[1].end == 2.0


def test_tag_non_interactive(tmp_path, capsys):
    d = str(tmp_path)
    tag("7777", d, sets_json=json.dumps([{"start": 0, "end": 0.5, "score": "5-3"}]))
    meta = MatchMeta.load("7777", d)
    assert len(meta.sets) == 1 and meta.sets[0].score == "5-3"


def test_claim_lockfile(tmp_path):
    lock = str(tmp_path / "x.lock")
    assert _claim(lock)
    assert not _claim(lock)  # second worker loses
    os.unlink(lock)
    assert _claim(lock)


def test_stabilise_idempotent(tmp_path):
    d = str(tmp_path)
    _write_clip(os.path.join(d, "GOPR5555.y4m"))
    stabilise("5555", d, concurrency=2)
    tpath = os.path.join(d, "GOPR5555.y4m.traj.npz")
    assert os.path.exists(tpath)
    assert os.path.exists(tpath + ".complete")
    mtime = os.path.getmtime(tpath)
    stabilise("5555", d)  # second run: skipped, file untouched
    assert os.path.getmtime(tpath) == mtime


def test_split_renders_sets_and_resumes(tmp_path, monkeypatch):
    # child render processes must not grab an accelerator; force them
    # onto host CPU like this test process
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    d = str(tmp_path)
    _write_clip(os.path.join(d, "match_9999.y4m"), n=20)
    MatchMeta(
        "9999", [MatchSet(0.0, 0.8, "11-9"), MatchSet(1.0, 1.9, "11-7")]
    ).save(d)
    split("9999", d, concurrency=1)
    out1 = os.path.join(d, "match_9999_set1.y4m")
    out2 = os.path.join(d, "match_9999_set2.y4m")
    assert os.path.exists(out1) and os.path.exists(out1 + ".complete")
    assert os.path.exists(out2)
    r = open_reader(out1)
    assert len(list(r)) == 8  # 0.8 s at 10 fps
    r.close()
    # resume: nothing re-rendered
    mtime = os.path.getmtime(out1)
    split("9999", d)
    assert os.path.getmtime(out1) == mtime


def test_split_without_join_errors(tmp_path):
    d = str(tmp_path)
    MatchMeta("1111", [MatchSet(0, 1)]).save(d)
    with pytest.raises(FileNotFoundError):
        split("1111", d)
