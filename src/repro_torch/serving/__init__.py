"""Serving: requests, per-model engines, the pool scheduler."""
