"""Tests of the benchmark (perfbench/)."""
