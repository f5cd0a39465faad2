"""``ttft_p95_ms`` of the chat cells, read in their traced runs, without
a bound: there a first token waits behind every monolithic prefill
admitted in the same step, so the 95th percentile of 120-270 first
tokens spread 12-17% between runs of the same seeds on an H100,
past half of the largest bound a metric may take."""

from perfbench.metrics.ttft_p95_ms import read  # noqa: F401
