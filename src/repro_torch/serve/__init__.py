"""The workload-facing pruning service and its resilience layer."""
