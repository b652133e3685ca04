"""The dense transformer LM."""
