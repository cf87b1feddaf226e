"""Dense and MoE decoder-only models for the serving engines and the
one-shot prefill."""
