"""Checkpoint format shared with the reference: the weights and state bridge."""
