"""Model configurations, parameter tables and the decoder-only LM (prefill)."""
