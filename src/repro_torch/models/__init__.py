"""Dense decoder-only models for the serving engines."""
