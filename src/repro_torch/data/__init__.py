"""Trace data layer of the port: synthetic generators + the spec-string
trace registry (:mod:`repro_torch.data.traces`) and real-trace file
ingestion (:mod:`repro_torch.data.ingest`) and the LM token pipeline
(:mod:`repro_torch.data.tokens`), copies of the reference's."""
from . import ingest
from .ingest import (DenseRemap, Trace, TraceChunk, TraceStats, characterize,
                     count_requests, detect_format, iter_chunks, load_trace,
                     write_csv, write_keys, write_oracle_general)
from .tokens import TokenPipeline
from .traces import (DATASET_FAMILIES, TIER_FAMILIES, TRACE_ALIASES, TRACES,
                     TraceSpec, churn_trace, dataset_family, family_batch,
                     family_footprint, family_trace, fetch_costs, file_trace,
                     k_for, make_trace, object_sizes, scan_mix_trace,
                     shifting_zipf_trace, tenants_trace, zipf_trace)

__all__ = [
    "ingest", "DenseRemap", "Trace", "TraceChunk", "TraceStats",
    "characterize", "count_requests", "detect_format", "iter_chunks",
    "load_trace", "write_csv", "write_keys", "write_oracle_general",
    "DATASET_FAMILIES", "TIER_FAMILIES", "TRACE_ALIASES", "TRACES",
    "TraceSpec", "churn_trace", "dataset_family", "fetch_costs",
    "file_trace", "make_trace", "object_sizes", "scan_mix_trace",
    "shifting_zipf_trace", "tenants_trace", "zipf_trace",
    "family_batch", "family_footprint", "family_trace", "k_for",
    "TokenPipeline",
]
