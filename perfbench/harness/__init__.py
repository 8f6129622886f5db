"""The benchmark's harness: cells, traffic, runners, traces and the check."""
