"""Trace data of the port: its own copy of the synthetic generators the
replay needs (:mod:`repro_torch.data.traces`)."""
from .traces import (DATASET_FAMILIES, churn_trace, family_batch,
                     family_footprint, family_trace, fetch_costs, k_for,
                     object_sizes, scan_mix_trace, shifting_zipf_trace,
                     zipf_trace)

__all__ = ["DATASET_FAMILIES", "churn_trace", "family_batch",
           "family_footprint", "family_trace", "fetch_costs", "k_for",
           "object_sizes", "scan_mix_trace", "shifting_zipf_trace",
           "zipf_trace"]
