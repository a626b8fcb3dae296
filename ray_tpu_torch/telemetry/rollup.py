"""Per-iteration span roll-up: stage wall-times + overlap fraction.

The port's copy of ``ray_tpu/telemetry/rollup.py`` (bitwise the same
numbers for the same span list). The spans recorded by the
instrumented hot path are point measurements; this
module turns one iteration's window of them into the summary that
lands in ``train()`` results under ``info/telemetry``:

- per-stage *busy* time (union of that stage's span intervals clamped
  to the window — concurrent spans of one stage don't double-count);
- the **overlap fraction**: of the time the learn nest ran, how much
  of it sampling was also running. 1.0 = fully pipelined (the
  ``sample_prefetch`` promise), 0.0 = strictly serial.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]

# span-name prefixes -> stage buckets. Worker-side spans arrive with
# their own names on the result message (core/worker_proc.py).
STAGE_PREFIXES: Dict[str, Tuple[str, ...]] = {
    "sample": ("rollout:", "sampler:", "sample:round"),
    "assemble": ("prefetch:assemble", "prefetch:deliver"),
    "transfer": ("feeder:transfer", "learn:transfer"),
    # learn:nest = the per-update SGD nest; learn:superstep = the
    # fused K-updates-per-dispatch program that replaces it on the
    # superstep path (without it, superstep runs reported learn_s 0)
    "learn": ("learn:nest", "learn:superstep"),
    # program execution intervals on the synthetic device lanes
    # (telemetry/device.py: CUDA-event times of graph replays and eager
    # nests) — busy time of the device itself, next to the host stages
    # that feed it
    "device": ("device:",),
    # time lost to the resilience layer: fleet probe+recreate,
    # checkpoint restore, periodic checkpoint writes (recovery:* spans)
    "recovery": ("recovery:",),
}

# stages whose spans count as "sampling is running" for the overlap
# computation: the worker-side rollout execution only (driver-side
# harvest bookkeeping isn't the work we want to overlap with)
_SAMPLING_FOR_OVERLAP = ("rollout:", "sampler:")


def merge_intervals(
    intervals: Iterable[Interval],
) -> List[Interval]:
    """Union of possibly-overlapping [start, end) intervals."""
    ivs = sorted(
        (s, e) for s, e in intervals if e > s
    )
    out: List[Interval] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def intersect(
    a: Sequence[Interval], b: Sequence[Interval]
) -> List[Interval]:
    """Intersection of two MERGED interval lists."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _clamped(
    spans: Iterable[dict], t0: float, t1: float, prefixes
) -> List[Interval]:
    out = []
    for s in spans:
        name = s.get("name", "")
        if not any(name.startswith(p) for p in prefixes):
            continue
        start = s.get("start")
        end = s.get("end") or start
        if start is None or end <= t0 or start >= t1:
            continue
        out.append((max(start, t0), min(end, t1)))
    return merge_intervals(out)


def late_stage_times(
    late_spans: Iterable[dict],
) -> Dict[str, float]:
    """Per-stage busy time of spans that arrived AFTER their own
    window settled (late cross-host harvest): full-duration union per
    stage, no window clamp — the window they belong to already rolled
    up without them, so the consumer credits them to its next window
    instead of dropping the time on the floor."""
    late_spans = list(late_spans)
    out: Dict[str, float] = {}
    for stage, prefixes in STAGE_PREFIXES.items():
        ivs = []
        for s in late_spans:
            name = s.get("name", "")
            if not any(name.startswith(p) for p in prefixes):
                continue
            start = s.get("start")
            end = s.get("end") or start
            if start is None or end is None:
                continue
            ivs.append((start, max(start, end)))
        out[stage] = total(merge_intervals(ivs))
    return out


def iteration_rollup(
    spans: Iterable[dict],
    t0: float,
    t1: float,
    late: Iterable[dict] = (),
) -> Dict[str, float]:
    """Summarize one iteration window ``[t0, t1]`` of finished spans.

    Returns ``{stage}_s`` busy times for each stage of
    :data:`STAGE_PREFIXES`, ``iteration_s``, and
    ``overlap_fraction`` = |learn ∩ sampling| / |learn| (0.0 when no
    learn span landed in the window).

    ``late`` names spans that were first harvested in THIS window but
    ended before it opened (their own window settled without them —
    the cross-host fleetview harvest can lag a full publish interval).
    Their full durations are credited to this window's stage totals
    via :func:`late_stage_times`, so the across-window sum matches an
    on-time harvest instead of silently losing the segments. The
    overlap fraction stays a pure in-window statement (late sampling
    can't retroactively overlap this window's learn)."""
    spans = list(spans)
    out: Dict[str, float] = {
        "iteration_s": max(0.0, t1 - t0)
    }
    late_times = late_stage_times(late) if late else {}
    merged: Dict[str, List[Interval]] = {}
    for stage, prefixes in STAGE_PREFIXES.items():
        merged[stage] = _clamped(spans, t0, t1, prefixes)
        out[f"{stage}_s"] = total(merged[stage]) + late_times.get(
            stage, 0.0
        )
    sampling = _clamped(spans, t0, t1, _SAMPLING_FOR_OVERLAP)
    learn = merged["learn"]
    learn_total = total(learn)
    out["overlap_fraction"] = (
        total(intersect(learn, sampling)) / learn_total
        if learn_total > 0
        else 0.0
    )
    return out
