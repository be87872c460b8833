"""Histogram buckets of the serving telemetry.

This package's copy of the serving half of
``skypilot_tpu/observability/runtime_metrics.py``: the same bucket
schemes, so the replica's ``skytpu_engine_ttft_seconds`` and
``skytpu_engine_token_seconds`` series expose the same ``le`` bounds as
the reference's.
"""
# Decode per-token latencies: the 100us-2.5s band.
TOKEN_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# The long-tail end (... 2.5/5/10/30/60 s) matters as much as the fast
# end: prefill-heavy requests on a saturated replica land there, and
# without those bounds p99 TTFT saturates into +Inf and is unreadable.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
