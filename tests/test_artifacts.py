"""README quoted figures must match the committed benchmark artifacts.

The reference's Profiler prints numbers and loses them
(``opencv/Profiler.cpp:25-34``); this framework commits every benchmark
as a JSON artifact instead — and this test closes the remaining drift
channel by parsing the figures README quotes and checking them against
the artifacts they claim to quote (the ``test_v1_surface`` pattern
applied to numbers). Artifacts carry
``{git_sha, captured_at_utc, backend}`` provenance stamps from
``benchmarks/provenance.py``; README text is matched by labeled
regexes, so a re-captured artifact fails this test until README's
quotes are updated with it.
"""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _artifact(name):
    path = os.path.join(ROOT, "benchmarks", name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not committed")
    with open(path) as f:
        return json.load(f)


def _readme():
    with open(os.path.join(ROOT, "README.md")) as f:
        return f.read()


def _quoted(pattern, text=None):
    """First float captured by `pattern` in README (group 1)."""
    m = re.search(pattern, text if text is not None else _readme(),
                  re.IGNORECASE | re.DOTALL)
    assert m, f"README no longer quotes: /{pattern}/"
    return float(m.group(1))


def test_readme_quality_rows_match_artifact():
    rows = {r["config"]: r for r in _artifact("quality.json")}
    readme = _readme()
    table = [
        ("rotation_smooth_savgol",
         r"`--stabilise smooth` \(savgol[^|]*\|[^|]*\|[^|]*\|\s*([\d.]+)"),
        ("rotation_smooth_kalman",
         r"`--smoother kalman`[^|]*\|[^|]*\|[^|]*\|\s*([\d.]+)"),
        ("rotation_smooth_kalman_streaming",
         r"`--smoother kalman --streaming`[^|]*\|[^|]*\|[^|]*\|\s*([\d.]+)"),
        ("rotation_fixed",
         r"`--stabilise fixed`[^|]*\|[^|]*\|[^|]*\|\s*([\d.]+)"),
        ("similarity_smooth",
         r"similarity \(vidstab\) smooth[^|]*\|[^|]*\|[^|]*\|\s*([\d.]+)"),
        ("deshake_smooth",
         r"deshake \(phase correlation\) smooth"
         r"[^|]*\|[^|]*\|[^|]*\|\s*([\d.]+)"),
    ]
    for config, pattern in table:
        assert config in rows, f"quality.json lost config {config}"
        quoted = _quoted(pattern, readme)
        actual = rows[config]["reduction_db"]
        assert quoted == pytest.approx(actual, abs=0.3), (
            f"README quotes {quoted} dB for {config}; "
            f"quality.json says {actual}")
    # The headline tradeoff figures (paired-vs-tracked trajectory RMS).
    for config, pattern in [
        ("rotation_smooth_paired_scale05",
         r"paired's trajectory RMS vs\s+ground truth is\s+([\d.]+)"),
        ("rotation_smooth_scale05", r"vs tracked's\s+([\d.]+)"),
    ]:
        quoted = _quoted(pattern, readme)
        actual = rows[config]["traj_rms_deg"]
        assert quoted == pytest.approx(actual, abs=5e-4), (
            f"README quotes {quoted}° for {config}; "
            f"quality.json says {actual}")


def test_committed_artifacts_are_host_measurements():
    """Committed artifacts hold only what a CPU or host run can say:
    quality scores (``quality.json``, CPU-stamped) and host decode/encode
    rates (``host_feed.json``). Device timings come only from a run on
    the accelerator and are never committed under a CPU stamp."""
    names = sorted(n for n in os.listdir(os.path.join(ROOT, "benchmarks"))
                   if n.endswith(".json"))
    assert names == ["host_feed.json", "quality.json"], names
    for name, backend in (("quality.json", "cpu"), ("host_feed.json", "host")):
        for rec in _artifact(name):
            assert rec["backend"] == backend, (name, rec.get("config"))


def test_artifacts_carry_provenance_stamps():
    """Every re-captured artifact is stamped; old captures grandfathered
    only until their next refresh (the stamp fields are added by
    benchmarks/provenance.py at emit time)."""
    for name in ("quality.json", "host_feed.json"):
        path = os.path.join(ROOT, "benchmarks", name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            data = json.load(f)
        records = data if isinstance(data, list) else [data]
        for rec in records:
            if "git_sha" in rec:
                assert rec.get("captured_at_utc") and rec.get("backend")


def test_provenance_stamp_fields():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "provenance", os.path.join(ROOT, "benchmarks", "provenance.py"))
    prov = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prov)
    rec = prov.stamp({"value": 1}, backend="host")
    assert rec["backend"] == "host"
    assert re.fullmatch(r"[0-9a-f]{7,}(-dirty)?|unknown", rec["git_sha"])
    assert re.fullmatch(
        r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}Z", rec["captured_at_utc"])


def test_trace_warp_busy_time_merges_overlapping_kernels():
    """The trace breakdown's busy time is the union of kernel intervals
    (concurrent streams are not counted twice)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_warp", os.path.join(ROOT, "benchmarks", "trace_warp.py"))
    tw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tw)
    assert tw.busy_ns([]) == 0
    assert tw.busy_ns([(0, 10), (5, 12), (20, 30), (21, 22)]) == 22
    assert tw.busy_ns([(20, 30), (0, 10)]) == 20
