"""Synthetic federated data and the device sampler."""
