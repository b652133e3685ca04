"""Observability: round telemetry probes, streamed metric shards, run
manifests and the run report."""

from repro_torch.obs.manifest import REQUIRED_KEYS, write_manifest
from repro_torch.obs.shards import (ShardWriter, format_summary, host_fetch,
                                    span_stats)
from repro_torch.obs.telemetry import (PROBE_KEYS, Telemetry, effective_cohort,
                                       state_norms, telemetry_probes, tree_norm)

__all__ = [
    "PROBE_KEYS", "REQUIRED_KEYS", "ShardWriter", "Telemetry",
    "effective_cohort", "format_summary", "host_fetch", "span_stats",
    "state_norms", "telemetry_probes", "tree_norm", "write_manifest",
]
