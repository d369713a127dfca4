"""Tests of the benchmark: ``pytest bench/tests``."""
