"""Tests of the benchmark harness (CPU; the card tests carry the cuda marker)."""
