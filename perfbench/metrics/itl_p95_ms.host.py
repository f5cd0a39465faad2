"""``itl_p95_ms`` of a cell whose device sits idle most of the window
(granite-3-8b.chat: 78-89% in traced runs on an H100), so that its gaps between
tokens are paced by the host's launches: the same reading, from the
traced run, without a bound."""

from perfbench.metrics.itl_p95_ms import read  # noqa: F401
