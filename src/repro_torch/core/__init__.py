"""Sketch operators, packed engine, adaptive server and SAFL round."""
