"""flightrec — black-box flight recorder and incident bundles; the
counterpart of :mod:`moolib_tpu.flightrec`.

- :mod:`~moolib_tpu_torch.flightrec.events` /
  :mod:`~moolib_tpu_torch.flightrec.recorder` — an always-on, bounded,
  lock-cheap ring of typed state-transition events, one per
  :class:`~moolib_tpu_torch.telemetry.Telemetry` (``telemetry.flight``),
  gated by one attribute check.
- :mod:`~moolib_tpu_torch.flightrec.bundle` /
  :mod:`~moolib_tpu_torch.flightrec.capture` — on a trigger the process
  freezes event ring + span ring + metrics + thread stacks + env
  fingerprint into a versioned, strictly-validated on-disk bundle, in the
  reference's format (a bundle of either package loads in the other).
- :mod:`~moolib_tpu_torch.flightrec.merge` — merges bundles of several
  peers into one clock-aligned, causally-ordered timeline (JSONL and
  Chrome trace).
- :mod:`~moolib_tpu_torch.flightrec.crawl` — reaches every peer of a
  cohort over the RPC from one address.
"""

from .events import KINDS, check_event_fields
from .recorder import FlightRecorder
from .bundle import (
    BUNDLE_SCHEMA,
    BUNDLE_VERSION,
    load_bundle,
    shift_bundle_ts,
    snapshot_bundle,
    validate_bundle,
    write_bundle,
)
from .capture import (
    auto_capture_dir,
    capture_incident,
    disable_auto_capture,
    enable_auto_capture,
    maybe_capture,
    recent_captures,
)
from .crawl import crawl_cohort
from .merge import (
    estimate_offset,
    merge_bundles,
    timeline_to_chrome,
    write_timeline_jsonl,
)

__all__ = [
    "KINDS",
    "check_event_fields",
    "FlightRecorder",
    "BUNDLE_SCHEMA",
    "BUNDLE_VERSION",
    "snapshot_bundle",
    "validate_bundle",
    "write_bundle",
    "load_bundle",
    "shift_bundle_ts",
    "capture_incident",
    "maybe_capture",
    "enable_auto_capture",
    "disable_auto_capture",
    "auto_capture_dir",
    "recent_captures",
    "crawl_cohort",
    "estimate_offset",
    "merge_bundles",
    "timeline_to_chrome",
    "write_timeline_jsonl",
]
